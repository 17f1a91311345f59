// B14 filter_contains: the stride-2 candidate screen for Hopper.
//
// Replaces the Pallas TPU kernel alfred_margaret_tpu/ops/filter_scan.py:
// make_filter_contains_kernel (launched from filter_contains: the screen that
// the comb16 engine asks before its sticky scan, with up to 3 words, and the
// grouped engine before its fused sticky scan, with up to 12).  Per stream,
// one step per byte pair (b1, b2) = (streams[t], streams[t + 1]),
// t = 2u < vend[s]:
//   h    = ((b1 & 15) << 3) | (b2 & 7)
//   D[v] = ((D[v] << 1) | seed[v]) & btab[v][h];   cand |= D[v] & endmask[v]
//   roll = (roll << 16) | (b1 << 8) | b2
//   exact |= (roll & mask[k]) == const[k] || ((roll >> 8) & mask[k]) == const[k]
// for V <= 12 candidate words (V a template argument) and K <= 8 short
// needles of at most 3 bytes (masks of at most 24 bits, so the logical shift
// here and the TPU kernel's arithmetic one agree).  From t >= vend[s] the TPU
// kernel freezes D and roll (cut at b1, since a match can end at the last
// valid byte); frozen registers change no plane.  The TPU kernel freezes on
// boundary tiles only (_strict_bscal), which equals freezing on every step
// for every stream that has data.  out[s] = exact, out[S + s] = cand.
//
// The design, for Hopper.  The first port ran one thread per whole stream,
// each waiting on a 1-byte device-memory load per byte strided by S, 256
// blocks on 132 SMs: 0.348 ms at 3 words and 0.349 at 12, latency-bound.
// Now, on stage.cuh's pipeline (as B4, the sticky mode of B2's scan):
//   * a block owns 128 streams and one of `segments` pieces of them, cut at
//     even steps (amt::pair_segment_steps) so that no pair straddles a cut;
//     segment y scans from the root (D = 0, roll = 0) starting `restart`
//     bytes before its own range, up to min(p_{y+1}, vend[s] rounded up to
//     even), and ORs its two planes into `out` with one atomicOr each where
//     they are non-zero (the wrapper zeroes `out`);
//   * the bytes are staged a tile of 32 steps (16 pairs) ahead with
//     cp.async, double buffered, so each thread reads its two bytes of a
//     pair from shared memory, one bank wavefront a warp;
//   * the planes are final once exact is set (or there is no short needle)
//     and cand holds every end bit.  Before each tile's steps a thread reads
//     the planes the stream's other segments stored (a relaxed load, looked
//     at after the steps; a stale read only delays the stop): where those
//     are final it stops without storing, where its own planes OR-ed with
//     them are final it stores its own at once and stops; a block stops
//     staging once all its threads have stopped (staged_scan's per-tile
//     vote), and leaves before its table loads when every stream's stored
//     planes are final.  So a stream that saturates early is scanned
//     about once however many segments it is cut into (config 5's 12 words:
//     35% of the live bytes).  No thread stops on another stream's planes:
//     they are per stream.
// Why the segments are exact.  A bucket of chains occupies bits [off, end]
// of its word with a seed at off (its longest chain, of end - off + 1 pairs
// at most floor(L / 2) + 1 for a needle of L bytes, ops/filter_scan.py
// _chains), so a register bit depends on at most the last end - off + 1
// pairs, and the short compares on the last two pairs.  The step is monotone
// in D and a zero byte matches no short needle (no needle holds NUL), so a
// scan restarted from the root sets a subset of the true bits and compares
// at every step, and it is in step from restart = max(2 (longest chain - 1),
// 2) bytes on (FilterTables.restart, derived from the layout; the wrapper
// checks it against the plan's overlap).  So every plane bit a segment sets
// is the stream's, and every pair of [0, vend) is some segment's own pair,
// where that segment is in step: the OR over segments is the stream's.
// The table and the short compares.  The table is [V][128], word v of hash h
// at v * 128 + h: a warp's 32 lanes hash to banks h & 31 and conflict 3-4
// ways on text, which bounds the scan at 12 words.  A layout replicating
// each entry per bank (lane l reading copy l % c) lost on the H100 at 3 and
// 12 words: fewer blocks fit an SM, and below 16 copies the worst bank of a
// warp's lookup still takes about three addresses (PERF.md section 6).  The
// short needles' compares run over KS slots (0, 4 or 8, a template
// argument; a padded slot has mask 0 and const 1 and never matches) with no
// branch: a run-time guard per slot split the unrolled pair loop (PERF.md
// section 6).  The exact plane is stored at the end of the tile that sets
// it, and a segment that reads it stored takes it as its own: from then on
// the stream's threads take their pairs without the compares (the roll is
// never read again), so on config 2's corpus, where a 1-byte short needle
// sets it within a few dozen bytes, nearly every pair runs the words alone.
// What bounds it: at 3 words the ALU (about 45 operations a pair), at 12
// words the shared-memory pipe (two staged bytes and twelve table loads a
// pair, three to four wavefronts each), against 138 MB of corpus bytes at
// 128 MiB.

#include <cstdint>
#include <cuda_runtime.h>
#include <type_traits>

#include "stage.cuh"

namespace {

constexpr int kThreads = amt::kStageThreads;
constexpr int kMaxWords = 12;
constexpr int kMaxShorts = 8;
constexpr int kMaxSegments = 64;

// Block (x, y): streams [128 x, 128 x + 128), segment y; V candidate words
// and KS short-needle slots (the first n_shorts real).
template <int V, int KS>
__global__ void __launch_bounds__(kThreads) filter_contains_kernel(
    const uint8_t* __restrict__ streams, int T, int S, const int32_t* __restrict__ vend,
    const int32_t* __restrict__ btab, const int32_t* __restrict__ seed,
    const int32_t* __restrict__ endmask, const int32_t* __restrict__ short_mask,
    const int32_t* __restrict__ short_const, int n_shorts, int restart, int segments, int tile,
    int32_t* __restrict__ out) {
  constexpr int NV = V > 0 ? V : 1;
  constexpr int NK = KS > 0 ? KS : 1;
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ int stop_slot;
  uint32_t full = 0;  // every end bit: cand can grow no further
#pragma unroll
  for (int v = 0; v < V; ++v) full |= (uint32_t)endmask[v];
  // Whether planes (exact, cand) are final: no later step can change them.
  auto final_planes = [&](uint32_t e, uint32_t c) { return (KS == 0 || e != 0u) && c == full; };
  {
    // A block whose streams' planes are all final already leaves before it
    // loads its table.
    const int sb = blockIdx.x * kThreads + threadIdx.x;
    if (__syncthreads_and(sb >= S || final_planes((uint32_t)amt::ld_relaxed(out + sb),
                                                  (uint32_t)amt::ld_relaxed(out + S + sb))))
      return;
  }
  uint32_t* bt = smem;
  for (int i = threadIdx.x; i < V * 128; i += blockDim.x) bt[i] = (uint32_t)btab[i];
  uint8_t* tiles = reinterpret_cast<uint8_t*>(smem + V * 128);

  const amt::SegSteps seg = amt::pair_segment_steps(blockIdx.y, segments, T, restart);
  const int s0 = blockIdx.x * kThreads;
  const int s = s0 + threadIdx.x;
  // This thread's pairs: [seg.start, hi), hi even (the pair of the last
  // valid byte reads one byte past vend, inside the stream since T is even).
  int hi = 0;
  if (s < S) hi = min(seg.hi, (min(vend[s], T) + 1) & ~1);
  const int stop = amt::block_stop(&stop_slot, seg.start, hi);  // also orders the table loads

  uint32_t sd[NV], em[NV], D[NV];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    sd[v] = (uint32_t)seed[v];
    em[v] = (uint32_t)endmask[v];
    D[v] = 0u;
  }
  uint32_t sm[NK], sc[NK];
#pragma unroll
  for (int k = 0; k < KS; ++k) {
    sm[k] = k < n_shorts ? (uint32_t)short_mask[k] : 0u;
    sc[k] = k < n_shorts ? (uint32_t)short_const[k] : 1u;
  }
  uint32_t roll = 0, exact = KS > 0 ? 0u : 1u, cand = 0;
  bool done = s >= S, stored = false, exact_stored = KS == 0;
  auto scan = [&](const uint8_t* cur, int t0, int rows) -> bool {
    if (!done) {
      // The planes other segments stored, read before the tile's steps and
      // looked at after them (a stale read only delays the stop).
      const uint32_t pe = (uint32_t)amt::ld_relaxed(out + s);
      const uint32_t pc = (uint32_t)amt::ld_relaxed(out + (size_t)S + s);
      const uint8_t* col = cur + threadIdx.x;
      const int r = min(rows, hi - t0);
      // The tile's pair steps, with the short compares (SHORTS) or, once
      // exact is set, without them: the words alone then decide.
      auto pairs = [&](auto shorts) {
#pragma unroll 4
        for (int j = 0; j < r; j += 2) {
          const uint32_t b1 = col[j * amt::kRowBytes], b2 = col[(j + 1) * amt::kRowBytes];
          const uint32_t* row = bt + (((b1 & 15u) << 3) | (b2 & 7u));
#pragma unroll
          for (int v = 0; v < V; ++v) {
            D[v] = ((D[v] << 1) | sd[v]) & row[v * 128];
            cand |= D[v] & em[v];
          }
          if constexpr (decltype(shorts)::value) {
            roll = (roll << 16) | (b1 << 8) | b2;
            const uint32_t r8 = roll >> 8;
            uint32_t hit = 0;
#pragma unroll
            for (int k = 0; k < KS; ++k)
              hit |= ((roll & sm[k]) == sc[k]) | ((r8 & sm[k]) == sc[k]);
            exact |= hit;
          }
        }
      };
      if (KS > 0 && !exact)
        pairs(std::true_type{});
      else
        pairs(std::false_type{});
      if (!exact_stored && (exact | pe)) {
        // The stream's exact plane is set: stored at once, and taken from the
        // other segments, so that no segment of the stream compares shorts
        // from its next tile on.
        if (exact) atomicOr(out + s, 1);
        exact = 1u;
        exact_stored = true;
      }
      if (final_planes(pe, pc)) {
        stored = done = true;  // final with what the others stored: nothing to add
      } else if (final_planes(exact | pe, cand | pc)) {
        // Final with this segment's planes: stored now, so that the stream's
        // other segments can stop.
        if (cand) atomicOr(out + (size_t)S + s, (int32_t)cand);
        stored = done = true;
      } else {
        done = t0 + rows >= hi;
      }
    }
    return done;
  };
  amt::staged_scan(tiles, tile, streams, S, s0, seg.start, stop, nullptr, scan);
  if (s < S && !stored && cand) atomicOr(out + (size_t)S + s, (int32_t)cand);
}

template <int V, int KS>
int launch(dim3 grid, cudaStream_t st, const uint8_t* sp, int T, int S, const int32_t* vp,
           const int32_t* bp, const int32_t* sdp, const int32_t* ep, const int32_t* mp,
           const int32_t* cp, int n_shorts, int restart, int segments, int32_t* op) {
  const size_t smem = (size_t)V * 128 * sizeof(uint32_t) + amt::kStageBytes;
  auto kernel = filter_contains_kernel<V, KS>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kThreads, smem, st>>>(sp, T, S, vp, bp, sdp, ep, mp, cp, n_shorts, restart,
                                       segments, amt::kTile, op);
  return (int)cudaGetLastError();
}

// The instance for V = n_words (V from Vmin up to kMaxWords) and the short
// slots n_shorts needs (0, 4 or 8).
template <int Vmin>
int launch_words(int n_words, dim3 grid, cudaStream_t st, const uint8_t* sp, int T, int S,
                 const int32_t* vp, const int32_t* bp, const int32_t* sdp, const int32_t* ep,
                 const int32_t* mp, const int32_t* cp, int n_shorts, int restart, int segments,
                 int32_t* op) {
  if constexpr (Vmin < kMaxWords) {
    if (n_words != Vmin)
      return launch_words<Vmin + 1>(n_words, grid, st, sp, T, S, vp, bp, sdp, ep, mp, cp,
                                    n_shorts, restart, segments, op);
  }
  auto go = n_shorts == 0 ? launch<Vmin, 0> : n_shorts <= 4 ? launch<Vmin, 4> : launch<Vmin, 8>;
  return go(grid, st, sp, T, S, vp, bp, sdp, ep, mp, cp, n_shorts, restart, segments, op);
}

}  // namespace

// out int32 [2, S], zeroed by the caller.  Each stream is cut into `segments`
// pieces at even steps, each scanned from `restart` bytes (even, >= 2) before
// its own range.  Launch on `stream` (a cudaStream_t); returns the
// cudaError_t of the launch; the kernel runs asynchronously.
extern "C" int amt_filter_contains(const void* streams, int T, int S, const void* vend,
                                   const void* btab, const void* seed, const void* endmask,
                                   int n_words, const void* short_mask,
                                   const void* short_const, int n_shorts, int restart,
                                   int segments, void* out, void* stream) {
  if (T < 0 || T % 2 || S <= 0 || n_words < 0 || n_words > kMaxWords || n_shorts < 0 ||
      n_shorts > kMaxShorts || restart < 2 || restart % 2 || segments < 1 ||
      segments > kMaxSegments)
    return (int)cudaErrorInvalidValue;
  return launch_words<0>(n_words, dim3((S + kThreads - 1) / kThreads, segments),
                         (cudaStream_t)stream, (const uint8_t*)streams, T, S,
                         (const int32_t*)vend, (const int32_t*)btab, (const int32_t*)seed,
                         (const int32_t*)endmask, (const int32_t*)short_mask,
                         (const int32_t*)short_const, n_shorts, restart, segments,
                         (int32_t*)out);
}
