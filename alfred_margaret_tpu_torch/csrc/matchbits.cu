// B6 matchbits: exact masked counts plus a one-bit-per-position hit bitmap,
// in one scan, for Hopper.
//
// Replaces the Pallas TPU kernel alfred_margaret_tpu/ops/pallas_scan.py:
// make_matchbits_kernel (launched from PallasAcEngine._get_bits_fn) with three
// of its step families: dense_bits_step_factory (the packed byte-class table),
// the one-word bitap step of bitap_scan.py:BitapAcEngine._bits_tables and the
// comb16 step of comb16_scan.py:_c16_bits_tables (kernel B13).  One kernel
// body, templated on the step:
//   DenseStep<P>: v = entry(carry + classmap[b]); carry = v & state_mask;
//                 cnt = v >> state_bits                  (tables as in B1)
//   BitapStep:    D = ((D << 1) | seed) & btab[b];
//                 cnt = sum over fields of ((D >> e) & 1) * weight  (as in B2)
//   Comb16Step:   e = lookup(carry, b); carry = e & (2^BB - 1);
//                 cnt = count16(e, carry)  (from the root's base; as in B8)
// Per stream s, per step t (T % 32 == 0), with no freeze anywhere:
//   counts[s] += cnt                        while warm[s] <= t < vend[s]
//   bit (t & 31) of bits[(t >> 5) * S + s]  is set iff cnt > 0
// The bitmap is unmasked, as on the TPU: it holds warm-up duplicates and, for
// machines whose zero byte is not inert, hits on the right-pad zeros; the host
// expansion keeps only bits in [warm, vend).  Bit 31 makes a word negative as
// int32; the host masks words with 0xFFFFFFFF.
//
// What bounds it: the step's own chain (two dependent shared-memory loads for
// the dense step, one table load for bitap, three to four for comb16) plus one coalesced 4-byte store
// per stream every 32 steps (1/8 byte per corpus byte: 17.3 MB at 128 MiB).
// The 32 stream bytes of a word are loaded ahead into registers.  The bitmap
// is compacted on the device by the caller (torch.nonzero over the words).

#include <cstdint>
#include <cuda_runtime.h>

#include "comb16.cuh"

namespace {

constexpr int kThreads = 128;
// MAX_ROWS (48) rows of 128 int32 entries: 24 KiB of shared memory.
constexpr int kMaxTableWords = 48 * 128;
// One bitap word: at most one count field per track bit.
constexpr int kMaxWordFields = 30;

template <class Step>
__device__ __forceinline__ void scan_bits(Step& step, const uint8_t* __restrict__ streams,
                                          int T, int S, int s, const int32_t* __restrict__ warm,
                                          const int32_t* __restrict__ vend,
                                          int32_t* __restrict__ counts,
                                          int32_t* __restrict__ bits) {
  const int w0 = warm[s];
  const int v0 = vend[s];
  const uint8_t* col = streams + s;
  uint32_t count = 0;
  for (int t0 = 0; t0 < T; t0 += 32) {
    uint8_t b[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) b[j] = col[(size_t)(t0 + j) * S];
    uint32_t word = 0;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const uint32_t cnt = step(b[j]);
      word |= (cnt != 0u ? 1u : 0u) << j;
      const int t = t0 + j;
      count += (t >= w0 && t < v0) ? cnt : 0u;
    }
    bits[(size_t)(t0 >> 5) * S + s] = (int32_t)word;
  }
  counts[s] = (int32_t)count;
}

template <int PACKING>
struct DenseStep {
  const uint32_t* cm;
  const uint32_t* tab;
  uint32_t mask;
  int state_bits;
  uint32_t carry;
  __device__ __forceinline__ uint32_t operator()(uint32_t b) {
    const uint32_t idx = carry + cm[b];
    const uint32_t v = PACKING == 1 ? tab[idx] : (tab[idx >> 1] >> ((idx & 1u) << 4)) & 0xFFFFu;
    carry = v & mask;
    return v >> state_bits;
  }
};

struct BitapStep {
  const uint32_t* bt;
  const uint32_t* fbit;
  const uint32_t* fwt;
  int n_fields;
  uint32_t seed, endmask, D;
  __device__ __forceinline__ uint32_t operator()(uint32_t b) {
    D = ((D << 1) | seed) & bt[b];
    if (!(D & endmask)) return 0u;
    uint32_t cnt = 0;
    for (int f = 0; f < n_fields; ++f) cnt += ((D >> fbit[f]) & 1u) * fwt[f];
    return cnt;
  }
};

struct Comb16Step {
  amt::Comb16 c;
  uint32_t ranges[amt::kC16Ranges];
  uint32_t bmask;
  bool counts;
  uint32_t carry;
  __device__ __forceinline__ uint32_t operator()(uint32_t b) {
    const uint32_t e = c.entry(carry, b);
    carry = e & bmask;
    return amt::count16(e, carry, ranges, counts);
  }
};

template <int PACKING>
__global__ void __launch_bounds__(kThreads) matchbits_dense_kernel(
    const uint8_t* __restrict__ streams, int T, int S, const int32_t* __restrict__ warm,
    const int32_t* __restrict__ vend, const int32_t* __restrict__ classmap,
    const int32_t* __restrict__ table, int table_words, int state_bits,
    int32_t* __restrict__ counts, int32_t* __restrict__ bits) {
  __shared__ uint32_t cm[256];
  extern __shared__ uint32_t tab[];
  for (int i = threadIdx.x; i < 256; i += blockDim.x) cm[i] = (uint32_t)classmap[i];
  for (int i = threadIdx.x; i < table_words; i += blockDim.x) tab[i] = (uint32_t)table[i];
  __syncthreads();
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= S) return;
  DenseStep<PACKING> step{cm, tab, (1u << state_bits) - 1u, state_bits, 0u};
  scan_bits(step, streams, T, S, s, warm, vend, counts, bits);
}

__global__ void __launch_bounds__(kThreads) matchbits_bitap_kernel(
    const uint8_t* __restrict__ streams, int T, int S, const int32_t* __restrict__ warm,
    const int32_t* __restrict__ vend, const int32_t* __restrict__ btab,
    const int32_t* __restrict__ seed, const int32_t* __restrict__ endmask,
    const int32_t* __restrict__ field_bit, const int32_t* __restrict__ field_weight,
    int n_fields, int32_t* __restrict__ counts, int32_t* __restrict__ bits) {
  __shared__ uint32_t bt[256];
  __shared__ uint32_t fbit[kMaxWordFields];
  __shared__ uint32_t fwt[kMaxWordFields];
  for (int i = threadIdx.x; i < 256; i += blockDim.x) bt[i] = (uint32_t)btab[i];
  for (int i = threadIdx.x; i < n_fields; i += blockDim.x) {
    fbit[i] = (uint32_t)field_bit[i];
    fwt[i] = (uint32_t)field_weight[i];
  }
  __syncthreads();
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= S) return;
  BitapStep step{bt, fbit, fwt, n_fields, (uint32_t)seed[0], (uint32_t)endmask[0], 0u};
  scan_bits(step, streams, T, S, s, warm, vend, counts, bits);
}

__global__ void __launch_bounds__(kThreads) matchbits_comb16_kernel(
    const uint8_t* __restrict__ streams, int T, int S, const int32_t* __restrict__ warm,
    const int32_t* __restrict__ vend, const int32_t* __restrict__ classmap,
    const int32_t* __restrict__ comb, int comb_words, const int32_t* __restrict__ aux,
    int aux_words, const int32_t* __restrict__ root_row, const int32_t* __restrict__ segtable,
    const int32_t* __restrict__ ranges, int bb, int owner_mask, int cbit, int root_cb,
    int32_t* __restrict__ counts, int32_t* __restrict__ bits) {
  extern __shared__ uint32_t smem[];
  const amt::Comb16 c = amt::load_comb16(smem, classmap, comb, comb_words, aux, aux_words,
                                         root_row, segtable, bb, owner_mask);
  __syncthreads();
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= S) return;
  Comb16Step step{c, {}, (1u << bb) - 1u, cbit != 0, (uint32_t)root_cb};
#pragma unroll
  for (int i = 0; i < amt::kC16Ranges; ++i) step.ranges[i] = (uint32_t)ranges[i];
  scan_bits(step, streams, T, S, s, warm, vend, counts, bits);
}

}  // namespace

// Dense step: counts int32 [S], bits int32 [T / 32, S].  Launch on `stream` (a
// cudaStream_t); returns the cudaError_t of the launch; the kernel runs
// asynchronously.
extern "C" int amt_matchbits_dense(const void* streams, int T, int S, const void* warm,
                                   const void* vend, const void* classmap,
                                   const void* table, int table_words, int packing,
                                   int state_bits, void* counts, void* bits,
                                   void* stream) {
  if (T < 0 || T % 32 || S <= 0 || table_words <= 0 || table_words > kMaxTableWords ||
      state_bits <= 0 || state_bits >= 32 || (packing != 1 && packing != 2))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((S + kThreads - 1) / kThreads);
  const size_t smem = (size_t)table_words * sizeof(uint32_t);
  cudaStream_t st = (cudaStream_t)stream;
  const uint8_t* sp = (const uint8_t*)streams;
  const int32_t* wp = (const int32_t*)warm;
  const int32_t* vp = (const int32_t*)vend;
  const int32_t* cp = (const int32_t*)classmap;
  const int32_t* tp = (const int32_t*)table;
  int32_t* cnt = (int32_t*)counts;
  int32_t* bp = (int32_t*)bits;
  if (packing == 1)
    matchbits_dense_kernel<1><<<grid, kThreads, smem, st>>>(sp, T, S, wp, vp, cp, tp, table_words, state_bits, cnt, bp);
  else
    matchbits_dense_kernel<2><<<grid, kThreads, smem, st>>>(sp, T, S, wp, vp, cp, tp, table_words, state_bits, cnt, bp);
  return (int)cudaGetLastError();
}

// One-word bitap step: btab int32 [256], seed and endmask int32 [1], n_fields
// count fields.  As amt_matchbits_dense otherwise.
extern "C" int amt_matchbits_bitap(const void* streams, int T, int S, const void* warm,
                                   const void* vend, const void* btab, const void* seed,
                                   const void* endmask, const void* field_bit,
                                   const void* field_weight, int n_fields, void* counts,
                                   void* bits, void* stream) {
  if (T < 0 || T % 32 || S <= 0 || n_fields < 1 || n_fields > kMaxWordFields)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((S + kThreads - 1) / kThreads);
  matchbits_bitap_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)streams, T, S, (const int32_t*)warm, (const int32_t*)vend,
      (const int32_t*)btab, (const int32_t*)seed, (const int32_t*)endmask,
      (const int32_t*)field_bit, (const int32_t*)field_weight, n_fields, (int32_t*)counts,
      (int32_t*)bits);
  return (int)cudaGetLastError();
}

// Comb16 step (B13): the tables of amt_comb16_count.  As amt_matchbits_dense
// otherwise.
extern "C" int amt_matchbits_comb16(const void* streams, int T, int S, const void* warm,
                                    const void* vend, const void* classmap, const void* comb,
                                    int comb_words, const void* aux, int aux_words,
                                    const void* root_row, const void* segtable,
                                    const void* ranges, int bb, int owner_mask, int cbit,
                                    int root_cb, void* counts, void* bits, void* stream) {
  if (T < 0 || T % 32 || S <= 0 ||
      !amt::comb16_args_ok(comb_words, aux_words, bb, owner_mask, cbit, root_cb))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((S + kThreads - 1) / kThreads);
  matchbits_comb16_kernel<<<grid, kThreads, amt::comb16_smem_bytes(comb_words, aux_words),
                            (cudaStream_t)stream>>>(
      (const uint8_t*)streams, T, S, (const int32_t*)warm, (const int32_t*)vend,
      (const int32_t*)classmap, (const int32_t*)comb, comb_words, (const int32_t*)aux,
      aux_words, (const int32_t*)root_row, (const int32_t*)segtable, (const int32_t*)ranges,
      bb, owner_mask, cbit, root_cb, (int32_t*)counts, (int32_t*)bits);
  return (int)cudaGetLastError();
}
