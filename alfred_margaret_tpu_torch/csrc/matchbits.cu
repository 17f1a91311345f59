// B6 matchbits: exact masked counts plus a one-bit-per-position hit bitmap,
// in one scan, for Hopper: the dense and one-word bitap steps.
//
// Replaces the Pallas TPU kernel alfred_margaret_tpu/ops/pallas_scan.py:
// make_matchbits_kernel (launched from PallasAcEngine._get_bits_fn and, per
// shard, from the sharded engine's extraction, parallel/shard.py:1219) with two
// of its step families: dense_bits_step_factory (the packed byte-class table)
// and the one-word bitap step of bitap_scan.py:BitapAcEngine._bits_tables.
// The third, the comb16 step of comb16_scan.py:_c16_bits_tables (kernel
// B13), is the bits mode of comb16_grouped.cu's one-group scan.
//   dense: v = entry(carry + cls); carry = v & state_mask;
//          cnt = v >> state_bits                           (tables as in B1)
//   bitap: D = ((D << 1) | seed) & mask(b);
//          cnt = sum over fields of ((D >> e) & 1) * weight, only where
//          D & endmask (about 1% of bytes)                 (as in B2)
// Per stream s, per step t (T % 32 == 0), with no freeze anywhere:
//   counts[s] += cnt                        while warm[s] <= t < vend[s]
//   bit (t & 31) of bits[(t >> 5) * S + s]  is set iff cnt > 0
// The bitmap is unmasked, as on the TPU: it holds warm-up duplicates and, for
// machines whose zero byte is not inert, hits on the right-pad zeros; the host
// expansion keeps only bits in [warm, vend).  Bit 31 makes a word negative as
// int32; the host masks words with 0xFFFFFFFF.
//
// The design, for Hopper.  The first port ran one thread per stream over all
// T steps, loading each word's 32 bytes straight from device memory: a
// 4096-stream mesh shard was 32 blocks on 132 SMs, one chain of T steps set
// the time, and each word waited out a device-memory round trip.  Now, on
// stage.cuh's pipeline (as B15 and B17):
//   * a block owns 128 streams and one of `segments` pieces of them, cut at
//     word boundaries (word_segment_steps): segment i scans from the root
//     at max(0, (p_i - overlap) & ~31), so it is in the stream's state by
//     step p_i, writes every word of its own range [p_i, p_{i+1}) (past vend
//     and on fully padded streams too: the wrapper does not clear the
//     bitmap) and adds its count over max(p_i, warm) <= t < min(p_{i+1},
//     vend) with one atomicAdd into counts, which the wrapper zeroes;
//   * the bytes are staged a tile of 32 steps ahead with cp.async, double
//     buffered, so a tile is one bitmap word of each of the block's streams,
//     stored once per 32 steps (a warp's 128 contiguous bytes);
//   * the dense step's tile is translated to byte classes in place through
//     the class map replicated per bank, so its chain is one table load;
//   * the bitap step reads its mask from the 256-word table on the raw
//     bytes: D's chain is ALU only and the load is off it.  (Translating the
//     tile to mask classes, the distinct rows of the table, and reading a
//     [classes][32] table replicated per bank lost at every segment count.)
// What bounds the scan now: the shared-memory pipe (a staged-byte read and
// one table load per step, the dense load on the state's chain) against the
// corpus bytes and the 17.3 MB of words at 128 MiB.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "dense.cuh"
#include "stage.cuh"

namespace {

constexpr int kThreads = amt::kStageThreads;
// One bitap word: at most one count field per track bit.
constexpr int kMaxWordFields = 30;
constexpr int kMaxSegments = 64;

// The scan of one block and segment: each staged tile is one word of each
// stream; step(x) takes the tile's byte (or class) and returns the count of
// the step.  Every thread of the block calls this.
template <class Step>
__device__ __forceinline__ void bits_scan(Step step, uint8_t* tiles, int tile,
                                          const uint8_t* __restrict__ streams, int T, int S,
                                          const int32_t* __restrict__ warm,
                                          const int32_t* __restrict__ vend, int overlap,
                                          int segments, const uint32_t* xlat,
                                          int32_t* __restrict__ counts,
                                          int32_t* __restrict__ bits) {
  const amt::SegSteps seg = amt::word_segment_steps(blockIdx.y, segments, T, overlap);
  const int s0 = blockIdx.x * kThreads;
  const int s = s0 + threadIdx.x;
  // The steps this thread counts, and the first word it stores.
  int lo = INT_MAX, hi = 0, own = INT_MAX;
  if (s < S) {
    lo = max(seg.lo, warm[s]);
    hi = min(seg.hi, min(vend[s], T));
    own = seg.lo;
  }
  uint32_t count = 0;
  int32_t* dst = bits + s;
  auto scan = [&](const uint8_t* cur, int t0, int rows) {
    const uint8_t* col = cur + threadIdx.x;
    uint32_t word = 0;
#pragma unroll 4
    for (int j = 0; j < rows; ++j) {
      const uint32_t cnt = step(col[j * amt::kRowBytes]);
      word |= (cnt != 0u ? 1u : 0u) << j;
      const int t = t0 + j;
      count += (t >= lo && t < hi) ? cnt : 0u;
    }
    if (t0 >= own) dst[(size_t)(t0 >> 5) * S] = (int32_t)word;
  };
  amt::staged_scan(tiles, tile, streams, S, s0, seg.start, seg.hi, xlat, scan);
  if (count) atomicAdd(counts + s, (int32_t)count);
}

struct BitapStep {
  const uint32_t* masks;
  const uint32_t* fbit;
  const uint32_t* fwt;
  int n_fields;
  uint32_t seed, endmask, D;
  __device__ __forceinline__ uint32_t operator()(uint32_t b) {
    D = ((D << 1) | seed) & masks[b];
    if (!(D & endmask)) return 0u;
    uint32_t cnt = 0;
    for (int f = 0; f < n_fields; ++f) cnt += ((D >> fbit[f]) & 1u) * fwt[f];
    return cnt;
  }
};

// Shared-memory words of the bitap step ahead of the two tiles (the dense
// step's are amt::dense_words).
constexpr int kBitapWords = (256 + 2 * kMaxWordFields + 3) & ~3;

// Block (x, y): streams [128 x, 128 x + 128), segment y.
template <int PACKING>
__global__ void __launch_bounds__(kThreads) matchbits_dense_kernel(
    const uint8_t* __restrict__ streams, int T, int S, const int32_t* __restrict__ warm,
    const int32_t* __restrict__ vend, const int32_t* __restrict__ classmap,
    const int32_t* __restrict__ table, int table_words, int state_bits, int overlap,
    int segments, int tile, int32_t* __restrict__ counts, int32_t* __restrict__ bits) {
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* rep = smem;
  uint32_t* tab = rep + amt::kRepWords;
  amt::load_rep_classes(rep, classmap);
  for (int i = threadIdx.x; i < table_words; i += blockDim.x) tab[i] = (uint32_t)table[i];
  // The first tile's barrier in staged_scan orders these loads before use.
  uint8_t* tiles = reinterpret_cast<uint8_t*>(smem + amt::dense_words(table_words));
  bits_scan(amt::DenseStep<PACKING>{tab, (1u << state_bits) - 1u, state_bits, 0u}, tiles, tile,
            streams, T, S, warm, vend, overlap, segments, rep, counts, bits);
}

__global__ void __launch_bounds__(kThreads) matchbits_bitap_kernel(
    const uint8_t* __restrict__ streams, int T, int S, const int32_t* __restrict__ warm,
    const int32_t* __restrict__ vend, const int32_t* __restrict__ btab,
    const int32_t* __restrict__ seed, const int32_t* __restrict__ endmask,
    const int32_t* __restrict__ field_bit, const int32_t* __restrict__ field_weight,
    int n_fields, int overlap, int segments, int tile, int32_t* __restrict__ counts,
    int32_t* __restrict__ bits) {
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* masks = smem;
  uint32_t* fbit = masks + 256;
  uint32_t* fwt = fbit + kMaxWordFields;
  for (int i = threadIdx.x; i < 256; i += blockDim.x) masks[i] = (uint32_t)btab[i];
  for (int i = threadIdx.x; i < n_fields; i += blockDim.x) {
    fbit[i] = (uint32_t)field_bit[i];
    fwt[i] = (uint32_t)field_weight[i];
  }
  uint8_t* tiles = reinterpret_cast<uint8_t*>(smem + kBitapWords);
  bits_scan(BitapStep{masks, fbit, fwt, n_fields, (uint32_t)seed[0], (uint32_t)endmask[0], 0u},
            tiles, tile, streams, T, S, warm, vend, overlap, segments, nullptr, counts, bits);
}

template <class Kernel, class... Args>
int launch_bits(Kernel kernel, size_t smem, int S, int segments, cudaStream_t stream,
                Args... args) {
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3((S + kThreads - 1) / kThreads, segments), kThreads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

bool shape_ok(int T, int S, int overlap, int segments) {
  return T >= 0 && T % 32 == 0 && S > 0 && overlap >= 0 && segments >= 1 &&
         segments <= kMaxSegments;
}

}  // namespace

// Dense step: counts int32 [S], zeroed by the caller; bits int32 [T / 32, S],
// every word written.  Each stream is cut into `segments` pieces at word
// boundaries (`overlap` is the stream plan's warm-up; with segments = 1 it is
// not read).  Launch on `stream` (a cudaStream_t); returns the cudaError_t of
// the launch; the kernel runs asynchronously.
extern "C" int amt_matchbits_dense(const void* streams, int T, int S, const void* warm,
                                   const void* vend, const void* classmap,
                                   const void* table, int table_words, int packing,
                                   int state_bits, int overlap, int segments, void* counts,
                                   void* bits, void* stream) {
  if (!shape_ok(T, S, overlap, segments) || table_words <= 0 ||
      table_words > amt::kMaxDenseTableWords || state_bits <= 0 || state_bits >= 32 ||
      (packing != 1 && packing != 2))
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      (size_t)amt::dense_words(table_words) * sizeof(uint32_t) + amt::kStageBytes;
  auto kernel = packing == 1 ? matchbits_dense_kernel<1> : matchbits_dense_kernel<2>;
  return launch_bits(kernel, smem, S, segments, (cudaStream_t)stream, (const uint8_t*)streams,
                     T, S, (const int32_t*)warm, (const int32_t*)vend,
                     (const int32_t*)classmap, (const int32_t*)table, table_words, state_bits,
                     overlap, segments, amt::kTile, (int32_t*)counts, (int32_t*)bits);
}

// One-word bitap step: btab int32 [256], seed and endmask int32 [1], n_fields
// count fields.  As amt_matchbits_dense otherwise.
extern "C" int amt_matchbits_bitap(const void* streams, int T, int S, const void* warm,
                                   const void* vend, const void* btab, const void* seed,
                                   const void* endmask, const void* field_bit,
                                   const void* field_weight, int n_fields, int overlap,
                                   int segments, void* counts, void* bits, void* stream) {
  if (!shape_ok(T, S, overlap, segments) || n_fields < 1 || n_fields > kMaxWordFields)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)kBitapWords * sizeof(uint32_t) + amt::kStageBytes;
  return launch_bits(matchbits_bitap_kernel, smem, S, segments, (cudaStream_t)stream,
                     (const uint8_t*)streams, T, S, (const int32_t*)warm, (const int32_t*)vend,
                     (const int32_t*)btab, (const int32_t*)seed, (const int32_t*)endmask,
                     (const int32_t*)field_bit, (const int32_t*)field_weight, n_fields, overlap,
                     segments, amt::kTile, (int32_t*)counts, (int32_t*)bits);
}
