// Stream staging for the segmented scans B1, B3 and B5 (dense_count.cu), B2
// and B4 (bitap_count.cu), B6 (matchbits.cu), B8, B9, B10, B11, B12 and B13
// (comb16_grouped.cu), B14 (filter_contains.cu), B15, B16 and B17
// (comb_scan.cu): a block's tile of stream bytes copied into shared memory
// ahead of the scan, and the per-segment step ranges.
//
// A block owns 128 streams [s0, s0 + 128).  Step t of those streams is the
// contiguous 128-byte run streams[t * S + s0 ...]; a tile of kTile steps is
// staged as kTile x 128 bytes, row-major, so thread i reads its stream's
// byte of row j at tile[j * 128 + i] (one bank wavefront per warp).  Tile
// i + 1 is in flight while tile i is scanned (two buffers).  With S and the
// staged stream count a multiple of 16 and a 16-byte aligned base the rows
// go as 16-byte cp.async copies, otherwise byte by byte (the ragged shapes
// only).  Bytes of streams past the staged count are not written: their
// threads scan but never count or store.  A scan over a range of streams
// (B3's [s0, s1)) passes streams + s0 as the base and s1 - s0 as the count,
// so no block stages a stream of the next range.
//
// Segments: stream steps [0, T) are cut into `segments` pieces at
// p_i = i * T / segments.  Segment i scans from the root starting `overlap`
// bytes early, at max(0, p_i - overlap); its own range is [p_i, p_{i+1}).
// The stream plan warms every stream with the same `overlap` bytes
// (max_needle_bytes - 1): after overlap + 1 bytes the state of a scan
// restarted from the root equals the state of the scan from the stream's
// start, whatever the bytes (NUL and padding too).  So a count over the
// steps max(p_i, warm[s]) <= t < min(p_{i+1}, vend[s]) is exact and adds
// per stream (B1, B8, B9, B15); a state written for each step of the own
// range is the stream's (B5, B12, B17); and a sticky scan up to
// min(p_{i+1}, vend[s]) absorbs iff a needle ends in [0, vend) inside its
// scanned steps, every match ending in some segment's own range (B3, B10,
// B11, B16).  The bitmap scans (B6, B13) cut at word boundaries instead
// (word_segment_steps): each segment writes the words of its own range,
// every one of them, and counts as B15 does.  The stride-2 screen (B14)
// steps over byte pairs and cuts at even steps (pair_segment_steps),
// restarting a layout-derived even number of bytes early.  kernels/segments.py is the same split.

#pragma once

#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace amt {

constexpr int kStageThreads = 128;  // streams per block
constexpr int kRowBytes = 128;      // one step of the block's streams
// Steps per staged tile (PERF.md section 6).  The launchers pass it to the
// kernels as an argument: with the step count a compile-time constant, nvcc
// schedules the scan loop otherwise, and B15 ran 3% and B9 with one group
// 5% slower on the H100.
constexpr int kTile = 32;
constexpr int kTileBytes = kTile * kRowBytes;
// Shared-memory bytes of the two tiles.
constexpr size_t kStageBytes = 2 * kTileBytes;
// A byte-packed class map replicated per bank: word (b >> 2) * 32 + lane
// holds the classes of bytes 4 (b >> 2) .. + 3, so each lane reads its own
// bank and a warp's lookup is one wavefront whatever its bytes.
constexpr int kRepWords = 64 * 32;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Issue the copy of steps [t0, t1) of streams [s0, min(s0 + 128, n)) into
// `tile` (rows S bytes apart) and commit it as one cp.async group (every
// thread of the block calls this).
__device__ inline void stage_rows(uint8_t* tile, const uint8_t* __restrict__ streams, int S,
                                  int n, int s0, int t0, int t1, bool vec) {
  const int rows = t1 - t0;
  if (vec) {
    for (int i = threadIdx.x; i < rows * 8; i += blockDim.x) {
      const int r = i >> 3, c = (i & 7) << 4;
      if (s0 + c < n) cp_async16(tile + r * kRowBytes + c, streams + (size_t)(t0 + r) * S + s0 + c);
    }
  } else {
    for (int i = threadIdx.x; i < rows * kRowBytes; i += blockDim.x) {
      const int r = i >> 7, c = i & 127;
      if (s0 + c < n) tile[i] = streams[(size_t)(t0 + r) * S + s0 + c];
    }
  }
  cp_async_commit();
}

// True when rows of n streams, S bytes apart, can go as 16-byte copies.
__device__ __forceinline__ bool stage_vec(const uint8_t* streams, int S, int n) {
  return (S & 15) == 0 && (n & 15) == 0 && ((uintptr_t)streams & 15) == 0;
}

// Fill the replicated class map from a [256] int32 class map (classes < 256).
__device__ inline void load_rep_classes(uint32_t* rep, const int32_t* __restrict__ classmap) {
  for (int i = threadIdx.x; i < kRepWords; i += blockDim.x) {
    const int w = (i >> 5) << 2;
    rep[i] = ((uint32_t)classmap[w] & 0xFFu) | (((uint32_t)classmap[w + 1] & 0xFFu) << 8) |
             (((uint32_t)classmap[w + 2] & 0xFFu) << 16) | (((uint32_t)classmap[w + 3] & 0xFFu) << 24);
  }
}

__device__ __forceinline__ uint32_t rep_class(const uint32_t* rep, uint32_t b, uint32_t lane) {
  return (rep[((b >> 2) << 5) + lane] >> ((b & 3u) << 3)) & 0xFFu;
}

// Replace the bytes of `rows` staged rows by their classes, in place, 16
// bytes a thread at a time (the block's threads together; the caller
// synchronises before and after).
__device__ inline void translate_rows(uint8_t* tile, int rows, const uint32_t* rep) {
  const uint32_t lane = threadIdx.x & 31u;
  uint4* v = reinterpret_cast<uint4*>(tile);
  for (int i = threadIdx.x; i < rows * 8; i += blockDim.x) {
    uint4 x = v[i];
    uint32_t* w = reinterpret_cast<uint32_t*>(&x);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint32_t u = w[q];
      w[q] = rep_class(rep, u & 0xFFu, lane) | (rep_class(rep, (u >> 8) & 0xFFu, lane) << 8) |
             (rep_class(rep, (u >> 16) & 0xFFu, lane) << 16) |
             (rep_class(rep, u >> 24, lane) << 24);
    }
    v[i] = x;
  }
}

// Segment i's steps: scan from `start`, count in [lo, hi) (before the
// per-stream warm and vend clamps).
struct SegSteps {
  int start, lo, hi;
};

__device__ __forceinline__ SegSteps segment_steps(int i, int segments, int T, int overlap) {
  const int lo = (int)((long long)i * T / segments);
  const int hi = (int)((long long)(i + 1) * T / segments);
  return SegSteps{max(0, lo - overlap), lo, hi};
}

// Segment i of the bitmap scans (T % 32 == 0): cut at word boundaries,
// p_i = 32 * floor(i * (T / 32) / segments), and scanned from
// max(0, (p_i - overlap) & ~31), so every staged tile of kTile = 32 steps is
// one bitmap word of every stream and the scan has read at least overlap + 1
// bytes by step p_i.  An empty own range scans nothing.
__device__ __forceinline__ SegSteps word_segment_steps(int i, int segments, int T, int overlap) {
  const int W = T >> 5;
  const int lo = (int)((long long)i * W / segments) << 5;
  const int hi = (int)((long long)(i + 1) * W / segments) << 5;
  return SegSteps{lo < hi ? max(0, (lo - overlap) & ~31) : lo, lo, hi};
}

// Segment i of the stride-2 screen (T even): cut at even steps, p_i = 2 *
// floor(i * (T / 2) / segments), and scanned from max(0, p_i - restart)
// (restart even), so every step the scan takes is a whole byte pair.  An
// empty own range scans nothing.
__device__ __forceinline__ SegSteps pair_segment_steps(int i, int segments, int T, int restart) {
  const int P = T >> 1;
  const int lo = (int)((long long)i * P / segments) << 1;
  const int hi = (int)((long long)(i + 1) * P / segments) << 1;
  return SegSteps{lo < hi ? max(0, lo - restart) : lo, lo, hi};
}

// A relaxed load of a word that other blocks store to (the sticky scans'
// poll of a stream's output, B3, B10 and B16).
__device__ __forceinline__ int32_t ld_relaxed(const int32_t* p) {
  int32_t v;
  asm volatile("ld.relaxed.gpu.global.s32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}

// Scan steps [start, stop) of the block's streams tile by tile: each tile of
// at most `tile` (kTile) rows is staged into one of the two buffers at
// `tiles` while the tile before it is scanned, and scan(cur, t0, rows) runs
// on it once it has landed.  With `xlat` (a replicated class map) the
// tile's bytes are first replaced by their classes.  A scan that returns a
// bool says whether its thread is done: the block stops once every thread
// is (a vote per tile).  Every thread of the block calls this, with the
// same arguments.  Streams [n, S) of the rows are not staged.
template <class Scan>
__device__ inline void staged_scan(uint8_t* tiles, int tile, const uint8_t* __restrict__ streams,
                                   int S, int n, int s0, int start, int stop,
                                   const uint32_t* xlat, Scan&& scan) {
  constexpr bool kVote = std::is_same<decltype(scan(tiles, 0, 0)), bool>::value;
  const int tile_bytes = tile * kRowBytes;
  const bool vec = stage_vec(streams, S, n);
  if (start < stop) stage_rows(tiles, streams, S, n, s0, start, min(start + tile, stop), vec);
  int it = 0;
  for (int t0 = start; t0 < stop; t0 += tile, ++it) {
    const int rows = min(tile, stop - t0);
    uint8_t* cur = tiles + (it & 1) * tile_bytes;
    const int t1 = t0 + rows;
    if (t1 < stop) {
      stage_rows(tiles + ((it + 1) & 1) * tile_bytes, streams, S, n, s0, t1,
                 min(t1 + tile, stop), vec);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (xlat != nullptr) {
      translate_rows(cur, rows, xlat);
      __syncthreads();
    }
    if constexpr (kVote) {
      // The barrier also frees the buffer, which is staged into again two
      // tiles on; a block that stops lets its last copy land first.
      if (__syncthreads_and(scan(cur, t0, rows))) {
        cp_async_wait<0>();
        return;
      }
    } else {
      scan(cur, t0, rows);
      __syncthreads();  // the buffer is staged into again two tiles on
    }
  }
}

// Every stream of the rows: staged_scan over streams [0, S).
template <class Scan>
__device__ inline void staged_scan(uint8_t* tiles, int tile, const uint8_t* __restrict__ streams,
                                   int S, int s0, int start, int stop, const uint32_t* xlat,
                                   Scan&& scan) {
  staged_scan(tiles, tile, streams, S, S, s0, start, stop, xlat, static_cast<Scan&&>(scan));
}

// The last step any stream of the block counts in its segment, or 0 when
// none counts (every thread of the block calls this; it synchronises).
__device__ inline int block_stop(int* slot, int lo, int hi) {
  if (threadIdx.x == 0) *slot = 0;
  __syncthreads();
  if (lo < hi) atomicMax(slot, hi);
  __syncthreads();
  return *slot;
}

}  // namespace amt
