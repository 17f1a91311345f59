// B9 comb16_count_grouped and B11 comb16_contains_grouped: the fused
// single-launch comb16 scans over G needle groups, for Hopper; and B11's
// one-group mode, comb16_contains_base.
//
// Replace the Pallas TPU kernels alfred_margaret_tpu/ops/comb16_scan.py:
// _make_c16_count_kernel_dyn (B9, launched from
// GroupedPallasAcEngine._get_fused_count_fn and, with one group, from the
// sharded engine's count step) and _make_c16_contains_kernel_dyn (B11: with
// n_groups > 1 from _get_fused_contains_fn; with n_groups == 1 from the
// sharded engine's sticky step, parallel/shard.py:616, where it writes each
// stream's final carried base and the absorb compare runs outside it).  The TPU kernels walk a sequential grid of
// G * n_tiles segments, group-major, reloading group g's table block for each
// of its segments and carrying counts or hit flags in scratch from one segment
// to the next.  Here the groups are a grid dimension: the CTA (g, j) loads
// group g's tables (one comb16 set of at most 48 rows plus the 1.5 KiB of
// class map, root row and segment table) into shared memory and scans streams
// [128 j, 128 j + 128) with the lookup of comb16.cuh, one stream per thread.
// The group index is the fastest grid dimension, so the G CTAs that read one
// block of streams are scheduled together and share its bytes in L2.
//
// B9, per group g, per stream s, per step t < vend[s]: the scan of B8 on
// group g's tables from its root base gscal[g][0], its count ranges
// gscal[g][1 ..] (padded with 2^BB), counting where warm[s] <= t; the thread
// adds its count to out[s] with one atomicAdd (out zeroed by the wrapper).
// Integer addition is order-free, so the sum is exact.
// B11, on the groups' sticky tables (CB = 0): the scan of B10 from gscal[g][0]
// until vend[s] or the group's absorbing base gscal[g][1], which loops to
// itself; out[s] = 1 (zeroed by the wrapper) if the final base is the
// absorbing one.  Every writer stores 1, so the races are benign.
// B11's one-group mode (G = 1): the same scan, out[s] = the final base.  The
// scan may stop at the absorbing base because that base loops to itself: the
// base after vend[s] steps is the absorbing one all the same.  A stream with
// vend[s] = 0 keeps the root base.
//
// What bounds them: per step B8's dependent chain of shared-memory loads,
// G times per stream byte: the kernels are latency-bound, like B8, and read
// each stream byte G times (from L2 after the first CTA of a block).  Left for
// later: several streams per thread, and stopping B11's groups once another
// group hit the stream.

#include <cstdint>
#include <cuda_runtime.h>

#include "comb16.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 16;

__global__ void __launch_bounds__(kThreads) comb16_count_grouped_kernel(
    const uint8_t* __restrict__ streams, int T, int S, const int32_t* __restrict__ warm,
    const int32_t* __restrict__ vend, const int32_t* __restrict__ classmap,
    const int32_t* __restrict__ comb, int comb_words, const int32_t* __restrict__ aux,
    int aux_words, const int32_t* __restrict__ root_row, const int32_t* __restrict__ segtable,
    const int32_t* __restrict__ gscal, int gscal_width, int bb, int owner_mask, int cbit,
    int32_t* __restrict__ out) {
  extern __shared__ uint32_t smem[];
  const int g = blockIdx.x;
  const amt::Comb16 c = amt::load_comb16(
      smem, classmap + (size_t)g * 256, comb + (size_t)g * comb_words, comb_words,
      aux + (size_t)g * aux_words, aux_words, root_row + (size_t)g * 128,
      segtable + (size_t)g * 128, bb, owner_mask);
  __syncthreads();

  const int s = blockIdx.y * blockDim.x + threadIdx.x;
  if (s >= S) return;
  const int32_t* gs = gscal + (size_t)g * gscal_width;
  const uint32_t bmask = (1u << bb) - 1u;
  uint32_t r[amt::kC16Ranges];
#pragma unroll
  for (int i = 0; i < amt::kC16Ranges; ++i)
    r[i] = i + 1 < gscal_width ? (uint32_t)gs[i + 1] : (1u << bb);
  const bool counts = cbit != 0;
  const int w0 = warm[s];
  const int v0 = min(vend[s], T);
  const uint8_t* col = streams + s;
  uint32_t cb = (uint32_t)gs[0] & bmask, count = 0;

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
  if (count) atomicAdd(out + s, (int32_t)count);
}

__global__ void __launch_bounds__(kThreads) comb16_contains_grouped_kernel(
    const uint8_t* __restrict__ streams, int T, int S, const int32_t* __restrict__ vend,
    const int32_t* __restrict__ classmap, const int32_t* __restrict__ comb, int comb_words,
    const int32_t* __restrict__ aux, int aux_words, const int32_t* __restrict__ root_row,
    const int32_t* __restrict__ segtable, const int32_t* __restrict__ gscal, int bb,
    int owner_mask, int32_t* __restrict__ out) {
  extern __shared__ uint32_t smem[];
  const int g = blockIdx.x;
  const amt::Comb16 c = amt::load_comb16(
      smem, classmap + (size_t)g * 256, comb + (size_t)g * comb_words, comb_words,
      aux + (size_t)g * aux_words, aux_words, root_row + (size_t)g * 128,
      segtable + (size_t)g * 128, bb, owner_mask);
  __syncthreads();

  const int s = blockIdx.y * blockDim.x + threadIdx.x;
  if (s >= S) return;
  const uint32_t bmask = (1u << bb) - 1u;
  const uint32_t absorb = (uint32_t)gscal[2 * g + 1] & bmask;
  const int v0 = min(vend[s], T);
  const uint8_t* col = streams + s;
  uint32_t cb = (uint32_t)gscal[2 * g] & bmask;

  int t = 0;
  for (; t + kChunk <= v0 && cb != absorb; t += kChunk) {
    uint8_t b[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) b[j] = col[(size_t)(t + j) * S];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) cb = c.entry(cb, b[j]) & bmask;
  }
  for (; t < v0 && cb != absorb; ++t) cb = c.entry(cb, col[(size_t)t * S]) & bmask;
  if (cb == absorb) out[s] = 1;
}

__global__ void __launch_bounds__(kThreads) comb16_contains_base_kernel(
    const uint8_t* __restrict__ streams, int T, int S, const int32_t* __restrict__ vend,
    const int32_t* __restrict__ classmap, const int32_t* __restrict__ comb, int comb_words,
    const int32_t* __restrict__ aux, int aux_words, const int32_t* __restrict__ root_row,
    const int32_t* __restrict__ segtable, const int32_t* __restrict__ gscal, int bb,
    int owner_mask, int32_t* __restrict__ out) {
  extern __shared__ uint32_t smem[];
  const amt::Comb16 c = amt::load_comb16(smem, classmap, comb, comb_words, aux, aux_words,
                                         root_row, segtable, bb, owner_mask);
  __syncthreads();

  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= S) return;
  const uint32_t bmask = (1u << bb) - 1u;
  const uint32_t absorb = (uint32_t)gscal[1] & bmask;
  const int v0 = min(vend[s], T);
  const uint8_t* col = streams + s;
  uint32_t cb = (uint32_t)gscal[0] & bmask;

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

// Groups ride in the grid's x dimension, blocks of streams in y (at most
// 65535 of them).
bool grid_ok(int G, int S) { return G > 0 && S > 0 && (S + kThreads - 1) / kThreads <= 65535; }

}  // namespace

// B9: out int32 [S], zeroed by the caller; the group tables are [G, ...]
// row-major, gscal [G, gscal_width] with gscal_width - 1 <= 6 count ranges.
// Launch on `stream` (a cudaStream_t); returns the cudaError_t of the launch;
// the kernel runs asynchronously.
extern "C" int amt_comb16_count_grouped(const void* streams, int T, int S, const void* warm,
                                        const void* vend, int G, const void* classmap,
                                        const void* comb, int comb_words, const void* aux,
                                        int aux_words, const void* root_row,
                                        const void* segtable, const void* gscal,
                                        int gscal_width, int bb, int owner_mask, int cbit,
                                        void* out, void* stream) {
  if (T < 0 || !grid_ok(G, S) || gscal_width < 1 || gscal_width > 1 + amt::kC16Ranges ||
      !amt::comb16_args_ok(comb_words, aux_words, bb, owner_mask, cbit, 0))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(G, (S + kThreads - 1) / kThreads);
  comb16_count_grouped_kernel<<<grid, kThreads, amt::comb16_smem_bytes(comb_words, aux_words),
                                (cudaStream_t)stream>>>(
      (const uint8_t*)streams, T, S, (const int32_t*)warm, (const int32_t*)vend,
      (const int32_t*)classmap, (const int32_t*)comb, comb_words, (const int32_t*)aux,
      aux_words, (const int32_t*)root_row, (const int32_t*)segtable, (const int32_t*)gscal,
      gscal_width, bb, owner_mask, cbit, (int32_t*)out);
  return (int)cudaGetLastError();
}

// B11: out int32 [S], zeroed by the caller: 1 where some group's sticky scan
// ended on its absorbing base; gscal [G, 2].  As amt_comb16_count_grouped
// otherwise.
extern "C" int amt_comb16_contains_grouped(const void* streams, int T, int S, const void* vend,
                                           int G, const void* classmap, const void* comb,
                                           int comb_words, const void* aux, int aux_words,
                                           const void* root_row, const void* segtable,
                                           const void* gscal, int bb, int owner_mask,
                                           void* out, void* stream) {
  if (T < 0 || !grid_ok(G, S) || !amt::comb16_args_ok(comb_words, aux_words, bb, owner_mask, 0, 0))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(G, (S + kThreads - 1) / kThreads);
  comb16_contains_grouped_kernel<<<grid, kThreads,
                                   amt::comb16_smem_bytes(comb_words, aux_words),
                                   (cudaStream_t)stream>>>(
      (const uint8_t*)streams, T, S, (const int32_t*)vend, (const int32_t*)classmap,
      (const int32_t*)comb, comb_words, (const int32_t*)aux, aux_words,
      (const int32_t*)root_row, (const int32_t*)segtable, (const int32_t*)gscal, bb, owner_mask,
      (int32_t*)out);
  return (int)cudaGetLastError();
}

// B11's one-group mode: out int32 [S], each stream's final base; the tables
// of one group (classmap [256], comb [comb_words], aux [aux_words], root_row
// and segtable [128], gscal [2] = root base, absorbing base).  As
// amt_comb16_count_grouped otherwise.
extern "C" int amt_comb16_contains_base(const void* streams, int T, int S, const void* vend,
                                        const void* classmap, const void* comb, int comb_words,
                                        const void* aux, int aux_words, const void* root_row,
                                        const void* segtable, const void* gscal, int bb,
                                        int owner_mask, void* out, void* stream) {
  if (T < 0 || !grid_ok(1, S) || !amt::comb16_args_ok(comb_words, aux_words, bb, owner_mask, 0, 0))
    return (int)cudaErrorInvalidValue;
  const int blocks = (S + kThreads - 1) / kThreads;
  comb16_contains_base_kernel<<<blocks, kThreads, amt::comb16_smem_bytes(comb_words, aux_words),
                                (cudaStream_t)stream>>>(
      (const uint8_t*)streams, T, S, (const int32_t*)vend, (const int32_t*)classmap,
      (const int32_t*)comb, comb_words, (const int32_t*)aux, aux_words,
      (const int32_t*)root_row, (const int32_t*)segtable, (const int32_t*)gscal, bb, owner_mask,
      (int32_t*)out);
  return (int)cudaGetLastError();
}
