// B2 bitap_count, B4 bitap_contains and B7 bitap_presence: the shift-AND
// (bitap) count, sticky and presence scans for Hopper.
//
// Replace the Pallas TPU kernels alfred_margaret_tpu/ops/bitap_scan.py:
// _make_bitap_count_kernel (B2, launched from
// BitapAcEngine._get_bitap_count_fn and, per shard, from the sharded engine's
// bitap count, parallel/shard.py:434), _make_bitap_contains_kernel (B4,
// from _get_bitap_contains_fn and, per shard, from the sharded engine's
// bitap sticky step, parallel/shard.py:509) and _make_bitap_presence_kernel
// (B7, from _get_bitap_presence_fn), each with its trap part.  Each stream
// keeps V <= 8 uint32 registers (V <= 3 with a trap, and for B4 and B7); the
// byte -> track-mask tables btab[V][256] and B2's count fields sit in shared
// memory.  One scan, bitap_count_kernel<V, TRAP, MODE>, serves all three:
// the mode (kCount, kSticky, kPresence) is a template parameter, since a
// run-time mode flag alone slowed B9's count by 25% (PERF.md section 6).
//
// Per stream s, per step t over b = streams[t * S + s], from D = 0:
//   D[w] = ((D[w] << 1) | seed[w]) & btab[w][b]         for every word w
// B2 (kCount): when t >= warm[s], for every field f of word w (end bit e,
// weight m)
//     count += ((D[w] >> e) & 1) * m
// and out[s] = count.  The fields of word w are field_bit/field_weight
// [field_start[w], field_start[w + 1]); they are read only on the rare steps
// where D[w] & endmask[w] is non-zero.  Taking the end bits every step gives
// the same integers as the TPU kernel's flush blocks of `unroll` steps, which
// only saved vector operations.
// B4 (kSticky): hit |= D[w] & endmask[w] at every step, with no warm mask
// (warm-up bytes are real corpus bytes, so a match there is a real match),
// and out[s] = hit: non-zero iff a needle ends in the stream.
// B7 (kPresence): H[w] |= D[w] & endmask[w] at every step, unmasked as B4's,
// and out[w * S + s] = H[w]: one plane per word, since the words share bit
// positions and one OR would alias their tracks.  Each set end bit flags its
// track's needle.
// Right-pad bytes are zero and btab[w][0] == 0 (no needle holds NUL), so the
// pads clear every register and count or flag nothing: the kernel takes no
// vend.
//
// The trap parts (TRAP = true: amt_bitap_count_trap, amt_bitap_contains_trap,
// amt_bitap_presence_trap) serve the byte-class IgnoreCase layouts: trap
// tracks watch for the length-changing unlowerings (İ, Kelvin K, Å, ẞ, ...)
// that a fixed-width track cannot hold, either in the spare high bits of the
// match words or in a standalone trap register, which is one more word with
// endmask 0 and no fields.  B2 and B4 also do at every step
//   tr |= D[w] & trapmask[w]                             for every word w
// with no warm masking (the TPU kernels mask only the counts), and
// trap_out[s] = tr.  B7 ORs the trap bits into their word's plane instead,
// H[w] |= D[w] & (endmask[w] | trapmask[w]), as the TPU kernel does, and
// writes no trap_out.  A stream whose trap is non-zero may under-count or
// miss a hit or a needle; the engine recovers it on the host, re-scans with
// the dense kernels or (B7) takes the extraction route.  With TRAP = false
// the template compiles to the kernels without a trap.
//
// The design, for Hopper.  The first ports ran one thread per stream over all
// T steps, loading bytes straight from device memory a 16-step chunk ahead:
// 32768 streams gave each SM about 8 warps, each waiting on device memory
// once a chunk, and a 4096-stream mesh shard was 32 blocks on 132 SMs.  Now,
// on stage.cuh's pipeline (as B6's one-word bitap step):
//   * a block owns 128 streams and one of `segments` pieces of them: segment
//     y scans with D = 0 from max(0, p_y - overlap); B2 counts the steps
//     max(p_y, warm[s]) <= t < p_{y+1} and adds them with one atomicAdd into
//     `out`; B4 ORs D & endmask over every step it scans (its warm-up too)
//     and sets them with one atomicOr; B7 ORs each word's plane over every
//     step it scans and sets each non-zero one with one atomicOr; B2 and B4
//     OR D & trapmask over every step they scan into `trap_out` with one
//     atomicOr; the wrappers zero every output;
//   * the bytes are staged a tile of 32 steps ahead with cp.async, double
//     buffered, and read raw: the mask load depends on the byte only, so it
//     is already off D's chain, which is ALU work.
// Why the segments are exact.  Bit i of track word w is set at step t iff
// the i + 1 bytes ending at t match the track's first i + 1 positions, so a
// register depends on the last L bytes only, L the longest track.  The step
// is monotone in D, so a register restarted from 0 holds a subset of the
// true bits at every step (the warm-up steps add no false end or trap bits),
// and from L steps on it equals the true register: by p_y when every track
// is at most overlap + 1 bytes long.  The stream plan's overlap is
// max_needle_bytes - 1; match tracks are needles (for a composed IgnoreCase
// machine max_needle_bytes = max_raw_match_bytes + 4, models/case_dfa.py)
// and trap tracks are unlowerings of needle code points, each at most
// max_raw_match_bytes long.  So every counted step sees the true register,
// every step of [0, T) is some segment's own step, and the OR of the hits or
// traps over the segments is the stream's.  B7 masks nothing either, so the
// argument holds word by word: each word's restarted register is a subset of
// its true one, equal to it from p_y on, and the OR of each word's planes
// over the segments is the stream's plane.  BitapAcEngine and the mesh
// refuse a staging whose overlap is shorter than its longest track less one
// (BitapTables.check_overlap).
// B4 and B7 take no early stop.  Stopping a block once every register has
// seen every end bit would be exact, but their output is final only then,
// and on the bench corpus (a needle word about every 700 bytes) a block of
// 128 streams almost never gets there before its end: the vote would be a
// branch and a barrier per tile that no traffic pays back.
// What bounds it: the shared-memory pipe (a staged byte and V table loads a
// step, the loads bank-conflicting where a warp's bytes share a bank),
// against 138 MB of corpus bytes at 128 MiB.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "stage.cuh"

namespace {

constexpr int kThreads = amt::kStageThreads;
constexpr int kMaxWords = 8;
// 30 track bits per word (bit 31 stays clear), at most one field per bit.
constexpr int kMaxFields = kMaxWords * 30;
// Words of a trap layout, and of B4 and B7: the 2-word budget plus a trap
// register.
constexpr int kMaxTrapWords = 3;
constexpr int kMaxSegments = 64;

// The scan's modes (a template parameter).
enum Mode : int { kCount = 0, kSticky = 1, kPresence = 2 };

// Shared-memory words ahead of the two tiles: the masks, then the fields'
// end bits and weights (rounded up to 16 bytes).
inline __host__ __device__ int table_words(int V, int n_fields) {
  return (V * 256 + 2 * n_fields + 3) & ~3;
}

// Block (x, y): streams [128 x, 128 x + 128), segment y.  B2 counts
// (kCount); B4 (kSticky) and B7 (kPresence) read no warm and no fields.
template <int V, bool TRAP, int MODE>
__global__ void __launch_bounds__(kThreads) bitap_count_kernel(
    const uint8_t* __restrict__ streams, int T, int S, const int32_t* __restrict__ btab,
    const int32_t* __restrict__ seed, const int32_t* __restrict__ endmask,
    const int32_t* __restrict__ field_start, const int32_t* __restrict__ field_bit,
    const int32_t* __restrict__ field_weight, int n_fields, const int32_t* __restrict__ warm,
    const int32_t* __restrict__ trapmask, int overlap, int segments, int tile,
    int32_t* __restrict__ out, int32_t* __restrict__ trap_out) {
  constexpr bool STICKY = MODE == kSticky;
  constexpr bool PRESENCE = MODE == kPresence;
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* bt = smem;
  uint32_t* fbit = bt + V * 256;
  uint32_t* fwt = fbit + n_fields;
  for (int i = threadIdx.x; i < V * 256; i += blockDim.x) bt[i] = (uint32_t)btab[i];
  for (int i = threadIdx.x; i < n_fields; i += blockDim.x) {
    fbit[i] = (uint32_t)field_bit[i];
    fwt[i] = (uint32_t)field_weight[i];
  }
  // The first tile's barrier in staged_scan orders these loads before use.
  uint8_t* tiles = reinterpret_cast<uint8_t*>(smem + table_words(V, n_fields));

  const amt::SegSteps seg = amt::segment_steps(blockIdx.y, segments, T, overlap);
  const int s0 = blockIdx.x * kThreads;
  const int s = s0 + threadIdx.x;
  // em: the end bits; B7's trap part takes the trap bits into them.
  uint32_t sd[V], em[V], tm[V], D[V], H[V];
#pragma unroll
  for (int w = 0; w < V; ++w) {
    sd[w] = (uint32_t)seed[w];
    em[w] = (uint32_t)endmask[w];
    if constexpr (TRAP && PRESENCE) {
      em[w] |= (uint32_t)trapmask[w];
    } else if constexpr (TRAP) {
      tm[w] = (uint32_t)trapmask[w];
    }
    D[w] = 0u;
    H[w] = 0u;  // B7: the word's plane
  }
  uint32_t tr = 0;
  int lo = INT_MAX;  // B2: the first step this thread counts
  int f0[V + 1];
  if constexpr (MODE == kCount) {
    if (s < S) lo = max(seg.lo, warm[s]);
#pragma unroll
    for (int w = 0; w <= V; ++w) f0[w] = field_start[w];
  }
  uint32_t acc = 0;  // B2: the count; B4: the OR of the end bits
  auto scan = [&](const uint8_t* cur, int t0, int rows) {
    const uint8_t* col = cur + threadIdx.x;
#pragma unroll 4
    for (int j = 0; j < rows; ++j) {
      const uint32_t b = col[j * amt::kRowBytes];
      uint32_t hit = 0;
#pragma unroll
      for (int w = 0; w < V; ++w) {
        D[w] = ((D[w] << 1) | sd[w]) & bt[w * 256 + b];
        if constexpr (PRESENCE) {
          H[w] |= D[w] & em[w];
        } else {
          hit |= D[w] & em[w];
          if constexpr (TRAP) tr |= D[w] & tm[w];
        }
      }
      if constexpr (STICKY) {
        acc |= hit;
      } else if constexpr (MODE == kCount) {
        if (hit && t0 + j >= lo) {
#pragma unroll
          for (int w = 0; w < V; ++w) {
            if (D[w] & em[w]) {
              for (int f = f0[w]; f < f0[w + 1]; ++f) acc += ((D[w] >> fbit[f]) & 1u) * fwt[f];
            }
          }
        }
      }
    }
  };
  amt::staged_scan(tiles, tile, streams, S, s0, seg.start, seg.hi, nullptr, scan);
  if constexpr (PRESENCE) {
    if (s < S) {
#pragma unroll
      for (int w = 0; w < V; ++w) {
        if (H[w]) atomicOr(out + (size_t)w * S + s, (int32_t)H[w]);
      }
    }
  } else if constexpr (STICKY) {
    if (acc && s < S) atomicOr(out + s, (int32_t)acc);
  } else if (acc) {
    atomicAdd(out + s, (int32_t)acc);
  }
  if constexpr (TRAP && !PRESENCE) {
    if (tr && s < S) atomicOr(trap_out + s, (int32_t)tr);
  }
}

template <int V, bool TRAP, int MODE>
int launch(const uint8_t* sp, int T, int S, const int32_t* bt, const int32_t* sd,
           const int32_t* em, const int32_t* fs, const int32_t* fb, const int32_t* fw,
           int n_fields, const int32_t* wp, const int32_t* tm, int overlap, int segments,
           int32_t* op, int32_t* tp, cudaStream_t st) {
  const size_t smem = (size_t)table_words(V, n_fields) * sizeof(uint32_t) + amt::kStageBytes;
  auto kernel = bitap_count_kernel<V, TRAP, MODE>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3((S + kThreads - 1) / kThreads, segments), kThreads, smem, st>>>(
      sp, T, S, bt, sd, em, fs, fb, fw, n_fields, wp, tm, overlap, segments, amt::kTile, op, tp);
  return (int)cudaGetLastError();
}

bool args_ok(int T, int S, int n_words, int top, int n_fields, int overlap, int segments) {
  return T >= 0 && S > 0 && n_words >= 1 && n_words <= top && n_fields >= 0 &&
         n_fields <= kMaxFields && overlap >= 0 && segments >= 1 && segments <= kMaxSegments;
}

// The launch of V words: every template instance the launchers dispatch to.
template <bool TRAP, int MODE, int V = 1>
int dispatch(int n_words, const uint8_t* sp, int T, int S, const int32_t* bt,
             const int32_t* sd, const int32_t* em, const int32_t* fs, const int32_t* fb,
             const int32_t* fw, int n_fields, const int32_t* wp, const int32_t* tm, int overlap,
             int segments, int32_t* op, int32_t* tp, cudaStream_t st) {
  constexpr int kTop = TRAP || MODE != kCount ? kMaxTrapWords : kMaxWords;
  if constexpr (V < kTop) {
    if (n_words > V)
      return dispatch<TRAP, MODE, V + 1>(n_words, sp, T, S, bt, sd, em, fs, fb, fw, n_fields,
                                         wp, tm, overlap, segments, op, tp, st);
  }
  return launch<V, TRAP, MODE>(sp, T, S, bt, sd, em, fs, fb, fw, n_fields, wp, tm, overlap,
                               segments, op, tp, st);
}

}  // namespace

// B2: out int32 [S], zeroed by the caller.  Each stream is cut into
// `segments` pieces (`overlap` is the stream plan's warm-up; with
// segments = 1 it is not read).  Launch on `stream` (a cudaStream_t).
// Returns the cudaError_t of the launch; the kernel runs asynchronously.
extern "C" int amt_bitap_count(const void* streams, int T, int S,
                               const void* btab, const void* seed,
                               const void* endmask, const void* field_start,
                               const void* field_bit, const void* field_weight,
                               int n_words, int n_fields, const void* warm,
                               int overlap, int segments, void* out, void* stream) {
  if (!args_ok(T, S, n_words, kMaxWords, n_fields, overlap, segments))
    return (int)cudaErrorInvalidValue;
  return dispatch<false, kCount>(n_words, (const uint8_t*)streams, T, S, (const int32_t*)btab,
                                 (const int32_t*)seed, (const int32_t*)endmask,
                                 (const int32_t*)field_start, (const int32_t*)field_bit,
                                 (const int32_t*)field_weight, n_fields, (const int32_t*)warm,
                                 nullptr, overlap, segments, (int32_t*)out, nullptr,
                                 (cudaStream_t)stream);
}

// B2's trap part: as amt_bitap_count over n_words <= 3 words (a standalone
// trap register included), with trapmask [n_words] and trap_out [S] int32,
// zeroed by the caller.
extern "C" int amt_bitap_count_trap(const void* streams, int T, int S,
                                    const void* btab, const void* seed,
                                    const void* endmask, const void* field_start,
                                    const void* field_bit, const void* field_weight,
                                    int n_words, int n_fields, const void* warm,
                                    const void* trapmask, int overlap, int segments,
                                    void* out, void* trap_out, void* stream) {
  if (!args_ok(T, S, n_words, kMaxTrapWords, n_fields, overlap, segments))
    return (int)cudaErrorInvalidValue;
  return dispatch<true, kCount>(n_words, (const uint8_t*)streams, T, S, (const int32_t*)btab,
                                (const int32_t*)seed, (const int32_t*)endmask,
                                (const int32_t*)field_start, (const int32_t*)field_bit,
                                (const int32_t*)field_weight, n_fields, (const int32_t*)warm,
                                (const int32_t*)trapmask, overlap, segments, (int32_t*)out,
                                (int32_t*)trap_out, (cudaStream_t)stream);
}

// B4: out int32 [S], zeroed by the caller, the OR of D & endmask over every
// step and word of n_words <= 3 registers.  Segments as amt_bitap_count.
extern "C" int amt_bitap_contains(const void* streams, int T, int S, const void* btab,
                                  const void* seed, const void* endmask, int n_words,
                                  int overlap, int segments, void* out, void* stream) {
  if (!args_ok(T, S, n_words, kMaxTrapWords, 0, overlap, segments))
    return (int)cudaErrorInvalidValue;
  return dispatch<false, kSticky>(n_words, (const uint8_t*)streams, T, S, (const int32_t*)btab,
                                  (const int32_t*)seed, (const int32_t*)endmask, nullptr,
                                  nullptr, nullptr, 0, nullptr, nullptr, overlap, segments,
                                  (int32_t*)out, nullptr, (cudaStream_t)stream);
}

// B4's trap part: hits as amt_bitap_contains, and trap_out int32 [S], zeroed
// by the caller, the OR of every word's D & trapmask.
extern "C" int amt_bitap_contains_trap(const void* streams, int T, int S, const void* btab,
                                       const void* seed, const void* endmask,
                                       const void* trapmask, int n_words, int overlap,
                                       int segments, void* out, void* trap_out, void* stream) {
  if (!args_ok(T, S, n_words, kMaxTrapWords, 0, overlap, segments))
    return (int)cudaErrorInvalidValue;
  return dispatch<true, kSticky>(n_words, (const uint8_t*)streams, T, S, (const int32_t*)btab,
                                 (const int32_t*)seed, (const int32_t*)endmask, nullptr, nullptr,
                                 nullptr, 0, nullptr, (const int32_t*)trapmask, overlap, segments,
                                 (int32_t*)out, (int32_t*)trap_out, (cudaStream_t)stream);
}

// B7: out int32 [n_words, S], zeroed by the caller, plane w the OR of
// D[w] & endmask[w] over every step of n_words <= 3 registers.  Segments as
// amt_bitap_count.
extern "C" int amt_bitap_presence(const void* streams, int T, int S, const void* btab,
                                  const void* seed, const void* endmask, int n_words,
                                  int overlap, int segments, void* out, void* stream) {
  if (!args_ok(T, S, n_words, kMaxTrapWords, 0, overlap, segments))
    return (int)cudaErrorInvalidValue;
  return dispatch<false, kPresence>(n_words, (const uint8_t*)streams, T, S,
                                    (const int32_t*)btab, (const int32_t*)seed,
                                    (const int32_t*)endmask, nullptr, nullptr, nullptr, 0,
                                    nullptr, nullptr, overlap, segments, (int32_t*)out, nullptr,
                                    (cudaStream_t)stream);
}

// B7's trap part: out int32 [n_words, S], zeroed by the caller, each plane
// the OR of D & (endmask | trapmask) of its word.
extern "C" int amt_bitap_presence_trap(const void* streams, int T, int S, const void* btab,
                                       const void* seed, const void* endmask,
                                       const void* trapmask, int n_words, int overlap,
                                       int segments, void* out, void* stream) {
  if (!args_ok(T, S, n_words, kMaxTrapWords, 0, overlap, segments))
    return (int)cudaErrorInvalidValue;
  return dispatch<true, kPresence>(n_words, (const uint8_t*)streams, T, S, (const int32_t*)btab,
                                   (const int32_t*)seed, (const int32_t*)endmask, nullptr,
                                   nullptr, nullptr, 0, nullptr, (const int32_t*)trapmask,
                                   overlap, segments, (int32_t*)out, nullptr,
                                   (cudaStream_t)stream);
}
