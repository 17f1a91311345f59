// screen_count: the count of a needle set, every (needle, end) pair, by a
// suffix screen and exact verification, for Hopper.  Written for this card;
// it replaces no TPU kernel.  The grouped engine (ops/grouped.py) runs it in
// place of B9's count wherever the needle set allows it
// (kernels/screen_count.py:plan_screen): no needle under 4 bytes or over 16,
// at most 8 distinct needles sharing a key, raw bytes.
//
// Why it was added.  B9 steps every group's automaton on every byte: config
// 5's first 1,000 needles take 11 uniform groups, each byte staged about
// three times (chunks of at most four groups) and stepped eleven times, each
// group step three data-dependent shared-memory probes and the count ranges.
// The kernel is bound by the SM's shared-memory pipe at about 50x its HBM
// bound (PERF.md section 6).  A count needs far fewer lookups a byte: test
// the last k bytes of the text at each step against a bitmap of the needles'
// keys, one probe, and compare the few candidates exactly.
//
// The stream layout, segments and [S] int32 output are B9's (stage.cuh): a
// thread a stream, 128 streams a block, bytes staged a tile of 32 steps ahead
// with cp.async, each stream cut into `segments` pieces that restart
// `overlap` bytes early.  Per thread:
//   * the last 16 bytes of its stream in four 32-bit words, w0 the newest
//     (step t's byte in its low 8 bits), zero before the segment's scan
//     start;
//   * at each step, the key (the last `key_bytes` = min(shortest needle, 8)
//     bytes, masked out of w0 and w1) hashed multiplicatively, and one word
//     of the shared-memory bitmap (2^bits bits) probed: a key sets two bits
//     of one word (a blocked Bloom filter), the word at the hash's top
//     bits - 5 bits, the two bits at the next two fields of 5, and the step
//     passes where both are set.  One load, as for one bit: at config 5's
//     first 1,000 keys in 2^17 bits it passes 0.26% of the positions
//     against one bit's 0.91% (0.14% are matches), which pays for its four
//     more operations a step (PERF.md section 6);
//   * where both bits are set at a counted step, max(seg.lo, warm[s]) <= t
//     < min(seg.hi, vend[s]), a screen pass.  The probes of a staged tile
//     run without a branch, each step's outcome a bit of a 32-bit mask; after the
//     tile, each pass replays the history from the tile's start up to its
//     step (the tile is still staged), so a warp's lanes diverge once a
//     tile rather than at every step where one of them passes;
//   * a pass looks the key up in an open-addressed table of the distinct
//     keys (linear probing from the hash's top bits), then compares each
//     distinct needle of that key with the history under the mask of its
//     length L, counted with its multiplicity where it matches and at least
//     L bytes have been read since the scan start (so that a needle holding
//     NUL never matches the zeroed history).  Both tables are in device
//     memory, read through the read-only cache: they are only read on a
//     pass.
// After the overlap + 1 >= longest-needle bytes a segment reads before its
// own range, its history is the stream's, so the segments' counts add up
// exactly (stage.cuh).  The thread adds its count to out[s] with one
// atomicAdd (out zeroed by the wrapper), and its number of passes to the
// 64-bit device counter `passes`, which only tests and chip_smoke.py read.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "stage.cuh"

namespace {

constexpr int kThreads = amt::kStageThreads;
constexpr int kMaxSegments = 64;
constexpr int kMinBits = 10;
constexpr int kMaxBits = 20;
// Multiplicative hash of a key (k0: its newest four bytes, k1: the rest,
// masked): ((k1 * kHashB) ^ k0) * kHashA, its top bits the bitmap's word and
// bits and the slot.  kernels/screen_count.py computes the same.
constexpr uint32_t kHashA = 0x9E3779B1u;
constexpr uint32_t kHashB = 0x85EBCA77u;

__device__ __forceinline__ uint32_t key_hash(uint32_t k0, uint32_t k1) {
  return ((k1 * kHashB) ^ k0) * kHashA;
}

__device__ __forceinline__ uint32_t byte_mask(int nb) {
  return nb >= 4 ? 0xFFFFFFFFu : (nb <= 0 ? 0u : (1u << (8 * nb)) - 1u);
}

// The multiplicity-weighted count of the distinct needles of key (k0, k1)
// that end at this step: the key's slot, then each of its records (int4 x 2:
// the needle's four words in the history's layout, bytes past L zero; then
// L and the multiplicity) against the history under the mask of L.
__device__ __noinline__ uint32_t verify(const int4* __restrict__ slots, uint32_t slot_mask,
                                        const int4* __restrict__ recs, uint32_t slot,
                                        uint32_t k0, uint32_t k1, uint32_t w0, uint32_t w1,
                                        uint32_t w2, uint32_t w3, int nread) {
  for (;;) {
    const int4 e = __ldg(slots + slot);
    if (e.w == 0) return 0;  // an empty slot: a false positive of the bitmap
    if ((uint32_t)e.x == k0 && (uint32_t)e.y == k1) {
      uint32_t c = 0;
      for (int i = e.z; i < e.z + e.w; ++i) {
        const int4 p = __ldg(recs + 2 * i);
        const int4 q = __ldg(recs + 2 * i + 1);
        const int L = q.x;
        if (L > nread) continue;
        const uint32_t diff = ((w0 ^ (uint32_t)p.x) & byte_mask(L)) |
                              ((w1 ^ (uint32_t)p.y) & byte_mask(L - 4)) |
                              ((w2 ^ (uint32_t)p.z) & byte_mask(L - 8)) |
                              ((w3 ^ (uint32_t)p.w) & byte_mask(L - 12));
        if (diff == 0) c += (uint32_t)q.y;
      }
      return c;
    }
    slot = (slot + 1) & slot_mask;
  }
}

__global__ void __launch_bounds__(kThreads)
    screen_count_kernel(const uint8_t* __restrict__ streams, int T, int S,
                        const int32_t* __restrict__ warm, const int32_t* __restrict__ vend,
                        const uint32_t* __restrict__ bitmap, int bits,
                        const int4* __restrict__ slots, int slot_bits,
                        const int4* __restrict__ recs, int key_bytes, int overlap, int segments,
                        int tile, int32_t* __restrict__ out,
                        unsigned long long* __restrict__ passes) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int stop_slot;
  uint8_t* tiles = smem;
  uint32_t* bm = reinterpret_cast<uint32_t*>(smem + 2 * tile * amt::kRowBytes);
  {
    const int n4 = (1 << bits) >> 7;  // the bitmap's uint4s
    const uint4* src = reinterpret_cast<const uint4*>(bitmap);
    uint4* dst = reinterpret_cast<uint4*>(bm);
    for (int i = threadIdx.x; i < n4; i += kThreads) dst[i] = __ldg(src + i);
  }

  const amt::SegSteps seg = amt::segment_steps(blockIdx.y, segments, T, overlap);
  const int s0 = blockIdx.x * kThreads;
  const int s = s0 + threadIdx.x;
  int lo = INT_MAX, hi = 0;
  if (s < S) {
    lo = max(seg.lo, warm[s]);
    hi = min(seg.hi, min(vend[s], T));
  }
  const int stop = amt::block_stop(&stop_slot, lo, hi);  // also orders the bitmap's loads

  const uint32_t kmask0 = byte_mask(key_bytes), kmask1 = byte_mask(key_bytes - 4);
  const int wshift = 32 - (bits - 5);  // the hash's top bits - 5 bits: the word
  const uint32_t slot_shift = 32 - slot_bits, slot_mask = (1u << slot_bits) - 1u;
  uint32_t w0 = 0, w1 = 0, w2 = 0, w3 = 0, count = 0, npass = 0;
  // One step: byte b into the key's two words (w2 and w3 are brought up to
  // date once a tile); 1 where both of its bits are set.
  auto probe = [&](uint32_t b) -> uint32_t {
    w1 = __funnelshift_l(w0, w1, 8);
    w0 = __byte_perm(w0, b, 0x2104);  // (w0 << 8) | b
    const uint32_t h = key_hash(w0 & kmask0, w1 & kmask1);
    const uint32_t m = __funnelshift_l(0u, 1u, h >> (wshift - 5)) |
                       __funnelshift_l(0u, 1u, h >> (wshift - 10));  // 1 << (x & 31)
    return (bm[h >> wshift] & m) == m ? 1u : 0u;
  };
  auto scan = [&](const uint8_t* tl, int t0, int rows) {
    const uint8_t* col = tl + threadIdx.x;
    const uint32_t v0 = w0, v1 = w1, v2 = w2, v3 = w3;  // the history before the tile
    // The history's words after `n` more of the tile's bytes from `j0` on.
    auto advance = [&](uint32_t& r0, uint32_t& r1, uint32_t& r2, uint32_t& r3, int j0, int n) {
      for (int j = j0; j < j0 + n; ++j) {
        r3 = __funnelshift_l(r2, r3, 8);
        r2 = __funnelshift_l(r1, r2, 8);
        r1 = __funnelshift_l(r0, r1, 8);
        r0 = __byte_perm(r0, col[j * amt::kRowBytes], 0x2104);
      }
    };
    uint32_t hits = 0;
    if (rows == amt::kTile) {
#pragma unroll
      for (int j = 0; j < amt::kTile; ++j) hits |= probe(col[j * amt::kRowBytes]) << j;
    } else {
#pragma unroll 4
      for (int j = 0; j < rows; ++j) hits |= probe(col[j * amt::kRowBytes]) << j;
    }
    if (rows >= 16) {  // bytes 8 to 15 back, from the tile
      auto word = [&](int j) {  // bytes j + 3 (low) down to j
        const uint8_t* c = col + j * amt::kRowBytes;
        return (uint32_t)c[3 * amt::kRowBytes] | ((uint32_t)c[2 * amt::kRowBytes] << 8) |
               ((uint32_t)c[amt::kRowBytes] << 16) | ((uint32_t)c[0] << 24);
      };
      w2 = word(rows - 12);
      w3 = word(rows - 16);
    } else {
      uint32_t r0 = v0, r1 = v1;
      w2 = v2, w3 = v3;
      advance(r0, r1, w2, w3, 0, rows);
    }
    // The passes: set bits at the tile's counted steps, [lo, hi) from t0.
    const int a = max(lo - t0, 0), e = min(hi - t0, rows);
    hits = a < e ? hits & (e == 32 ? ~0u : (1u << e) - 1u) & ~((1u << a) - 1u) : 0u;
    // Each pass verified after the tile, its history replayed from the
    // tile's start: the probes above run without a branch.
    uint32_t r0 = v0, r1 = v1, r2 = v2, r3 = v3;
    for (int jj = 0; hits; hits &= hits - 1u) {
      const int j = __ffs(hits) - 1;
      advance(r0, r1, r2, r3, jj, j + 1 - jj);
      jj = j + 1;
      const uint32_t k0 = r0 & kmask0, k1 = r1 & kmask1;
      ++npass;
      count += verify(slots, slot_mask, recs, key_hash(k0, k1) >> slot_shift, k0, k1, r0, r1,
                      r2, r3, t0 + j - seg.start + 1);
    }
  };
  amt::staged_scan(tiles, tile, streams, S, s0, seg.start, stop, nullptr, scan);
  if (count) atomicAdd(out + s, (int32_t)count);
  if (npass) atomicAdd(passes, (unsigned long long)npass);
}

}  // namespace

// out int32 [S], zeroed by the caller: per stream, the multiplicity-weighted
// matches of the needle set ending at a step t with warm[s] <= t < vend[s].
// bitmap: 2^bits bits (uint32 words, 16-byte aligned); slots int32
// [2^slot_bits, 4] (key0, key1, first record, records; 0 records: empty);
// recs int32 [n, 8]; key_bytes 1..8 (the grouped engine's route takes 4..8); passes:
// one unsigned 64-bit counter the screen passes are added to.  Each stream is
// cut into `segments` pieces (stage.cuh segment_steps; `overlap` is the
// stream plan's warm-up, at least the longest needle less one).  Launch on
// `stream` (a cudaStream_t); returns the cudaError_t of the launch (also when
// the shared memory asked for is refused); the kernel runs asynchronously.
extern "C" int amt_screen_count(const void* streams, int T, int S, const void* warm,
                                const void* vend, const void* bitmap, int bits,
                                const void* slots, int slot_bits, const void* recs,
                                int key_bytes, int overlap, int segments, void* out,
                                void* passes, void* stream) {
  if (T < 0 || S <= 0 || bits < kMinBits || bits > kMaxBits || slot_bits < 1 ||
      slot_bits > 24 || key_bytes < 1 || key_bytes > 8 || overlap < 0 || segments < 1 ||
      segments > kMaxSegments || ((uintptr_t)bitmap & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = amt::kStageBytes + ((size_t)1 << bits) / 8;
  const cudaError_t err = cudaFuncSetAttribute(
      screen_count_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + kThreads - 1) / kThreads, segments);
  screen_count_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)streams, T, S, (const int32_t*)warm, (const int32_t*)vend,
      (const uint32_t*)bitmap, bits, (const int4*)slots, slot_bits, (const int4*)recs, key_bytes,
      overlap, segments, amt::kTile, (int32_t*)out, (unsigned long long*)passes);
  return (int)cudaGetLastError();
}
