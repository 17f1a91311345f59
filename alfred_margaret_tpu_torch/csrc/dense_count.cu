// B1 dense_count: the byte-class-compressed DFA count kernel for Hopper, B3
// dense_contains, its sticky mode, and B5 dense_states, its states mode.
//
// B1 replaces the Pallas TPU kernel alfred_margaret_tpu/ops/pallas_scan.py:
// _make_count_kernel (launched from PallasAcEngine._get_count_fn and, per
// shard, from the sharded engine's dense count, parallel/shard.py:325).  It
// computes what that kernel computes, not how: the TPU version gathers
// 128-lane table rows with a select chain and relies on mod-128 lane
// indexing; here the packed table sits in shared memory (dense.cuh).
//
// Per stream s, per step t over streams[t * S + s], from the root:
//   v = entry(sbase + classmap[byte]);  sbase = v & state_mask
//   count += v >> state_bits            while warm[s] <= t < vend[s]
// and out[s] = count.  Nothing at or after vend[s] counts.
//
// The design, for Hopper.  The first port ran one thread per stream over all
// T steps, loading bytes straight from device memory a 16-step chunk ahead:
// each step was a dependent chain of two shared-memory loads (class, then
// entry), 32768 streams gave each SM about 8 warps, and a 4096-stream mesh
// shard was 32 blocks on 132 SMs.  Now it is B15's count mode with B6's
// dense step, on stage.cuh's pipeline:
//   * a block owns 128 streams and one of `segments` pieces of them: segment
//     y scans from the root at max(0, p_y - overlap) and counts the steps
//     max(p_y, warm[s]) <= t < min(p_{y+1}, vend[s]), which is exact because
//     the stream plan's overlap (max_needle_bytes - 1) brings a restarted
//     scan into the stream's state by p_y; the per-stream sums add with one
//     atomicAdd into `out`, which the wrapper zeroes;
//   * the block stops at the last vend of its streams in the segment
//     (amt::block_stop);
//   * the bytes are staged a tile of 32 steps ahead with cp.async, double
//     buffered, and each tile is translated to byte classes in place through
//     the class map replicated per bank, so the chain is one packed-table
//     load a step.
// What bounds it now: the SM's shared-memory pipe (a staged class and one
// table load per step, the load on the state's chain) against 138 MB of
// corpus bytes at 128 MiB.
//
// B3 replaces the Pallas TPU kernel pallas_scan.py:_make_contains_kernel
// (launched from PallasAcEngine._get_contains_fn and, one stream-row segment
// per launch, _get_contains_seg_fn; per shard from the sharded engine's dense
// sticky step, parallel/shard.py:997).  The tables are the sticky view's
// (_StickyView): entering any match state leads to one extra state that loops
// to itself, and no entry carries a count.  Per stream s in [s0, s1), the
// same step over t < vend[s], the entry held from vend[s] on, and out[s - s0]
// = the final entry, which is `absorb` (the absorbing state times k) iff the
// stream saw a match.  The first port ran one thread per stream over all T
// steps, as B1's did; a warp ran until its slowest stream ended, so its stop
// at `absorb` bought almost nothing.  Now it is B1's scan in a compile-time
// sticky mode, over the range [s0, s1) (block x covers s0 + 128 x; the
// staging takes streams + s0 as its base and s1 - s0 streams):
//   * segment y scans [max(0, p_y - overlap), min(p_{y+1}, vend[s])) from
//     the root with no warm mask: warm-up matches are real haystack bytes;
//   * a stream that never absorbs runs the plain AC scan, so a segment whose
//     own range holds step vend[s] - 1 ends in the stream's final entry; and
//     an absorb is a real match in [0, vend), every one of which ends in some
//     segment's own range, where that segment is in step.  The segments
//     combine as B11's one-group mode does (comb16_grouped.cu): the wrapper
//     fills out with the root entry 0, a segment that absorbed stores
//     `absorb` with atomicExch, and the owner of step vend[s] - 1 stores its
//     entry with atomicCAS from the root; vend[s] = 0 keeps the root;
//   * a thread stops stepping once its entry is `absorb` or once it reads
//     `absorb` in out[s], stored by another segment of its stream (a relaxed
//     load a tile), and a block stops staging once every thread has stopped
//     (staged_scan's per-tile vote).  With one segment of k = 16 a block
//     covers about 264 steps and seldom holds a match for all 128 of its
//     streams, so the vote alone seldom fires; with the poll, B3 took 6%
//     less time on the bench needles and the same on a full scan (H100,
//     PERF.md section 6).
// What bounds B3: as B1, the shared-memory pipe, one staged class and one
// table load a step, against the bytes up to each stream's first match
// (its vend where it has none).
//
// B5 dense_states, the packed entry at every step, replaces the Pallas TPU
// kernel pallas_scan.py:_make_states_kernel (launched from
// PallasAcEngine._get_states_fn and, per shard, from the sharded engine's
// states step, parallel/shard.py:1134).  The same lookup from the root, with
// no [warm, vend) window: every step t < T of every stream writes
//   out[t * S + s] = v
// (the whole entry, zero-extended from 16 bits at packing 2), before warm,
// past vend and on padding too, and the host picks the window (match
// extraction, the final_states stitch).  The first port ran one thread per
// stream over all T steps, bytes loaded 16 steps ahead into registers, two
// shared-memory loads a step.  Now it is B1's scan in a compile-time states
// mode, as B17 is B15's (comb_scan.cu):
//   * block (x, y) scans its 128 streams from the root at max(0, p_y -
//     overlap) and writes every row of its own range [p_y, p_{y+1}), each
//     row once: the plan's overlap brings a restarted scan into the stream's
//     state by p_y (stage.cuh), so the rows are the unsplit scan's;
//   * the bytes are staged a tile ahead and translated to classes in place,
//     so the chain is one packed-table load a step;
//   * the stores are evict-first (__stcs): the entries are read once more,
//     by compact_packed or the final_states gather, after the whole array
//     passed through L2.
// What bounds B5: the 4-byte write a step, 553.6 MB at 128 MiB (0.165 ms of
// the 0.207 ms bound at 3.35 TB/s), each warp 128 contiguous bytes a step.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "dense.cuh"
#include "stage.cuh"

namespace {

constexpr int kThreads = amt::kStageThreads;
constexpr int kMaxSegments = 64;

// The scan's modes (a template parameter).
enum Mode : int { kCount = 0, kSticky = 1, kStates = 2 };

// Block (x, y): streams s_base + [128 x, 128 x + 128) of the n from s_base,
// segment y.  B1 counts (kCount, the whole [0, S)); B3 carries the sticky
// entry (kSticky, below); B5 writes the entries of the segment's own range
// to out [T, S] (kStates, the whole [0, S); warm and vend are not read).
template <int PACKING, int MODE>
__global__ void __launch_bounds__(kThreads) dense_count_kernel(
    const uint8_t* __restrict__ streams, int T, int S, const int32_t* __restrict__ classmap,
    const int32_t* __restrict__ table, int table_words, const int32_t* __restrict__ warm,
    const int32_t* __restrict__ vend, int state_bits, int overlap, int segments, int tile,
    int s_base, int n, uint32_t absorb, int32_t* __restrict__ out) {
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ int stop_slot;
  uint32_t* rep = smem;
  uint32_t* tab = rep + amt::kRepWords;
  amt::load_rep_classes(rep, classmap);
  for (int i = threadIdx.x; i < table_words; i += blockDim.x) tab[i] = (uint32_t)table[i];
  uint8_t* tiles = reinterpret_cast<uint8_t*>(smem + amt::dense_words(table_words));

  const amt::SegSteps seg = amt::segment_steps(blockIdx.y, segments, T, overlap);
  const int i0 = blockIdx.x * kThreads;
  const int i = i0 + threadIdx.x;  // this thread's stream: s_base + i
  amt::DenseStep<PACKING> step{tab, (1u << state_bits) - 1u, state_bits, 0u};
  if constexpr (MODE == kStates) {
    // staged_scan's first barrier orders the table loads.
    const int lo = i < n ? seg.lo : INT_MAX;  // the rows this thread writes from
    int32_t* dst = out + i;
    auto scan = [&](const uint8_t* cur, int t0, int rows) {
      const uint8_t* col = cur + threadIdx.x;
#pragma unroll 4
      for (int j = 0; j < rows; ++j) {
        const uint32_t e = step.entry(col[j * amt::kRowBytes]);
        const int t = t0 + j;
        if (t >= lo) __stcs(dst + (size_t)t * S, (int32_t)e);
      }
    };
    amt::staged_scan(tiles, tile, streams, S, i0, seg.start, seg.hi, rep, scan);
    return;
  }
  constexpr bool STICKY = MODE == kSticky;
  // B1 counts the steps [lo, hi); B3 scans [seg.start, hi).
  int lo = INT_MAX, hi = 0;
  if (i < n) {
    lo = STICKY ? seg.start : max(seg.lo, warm[s_base + i]);
    hi = min(seg.hi, min(vend[s_base + i], T));
  }
  const int stop = amt::block_stop(&stop_slot, lo, hi);  // also orders the table loads

  if constexpr (!STICKY) {
    uint32_t count = 0;
    auto scan = [&](const uint8_t* cur, int t0, int rows) {
      const uint8_t* col = cur + threadIdx.x;
#pragma unroll 4
      for (int j = 0; j < rows; ++j) {
        const uint32_t cnt = step(col[j * amt::kRowBytes]);
        const int t = t0 + j;
        count += (t >= lo && t < hi) ? cnt : 0u;
      }
    };
    amt::staged_scan(tiles, tile, streams, S, i0, seg.start, stop, rep, scan);
    if (count) atomicAdd(out + i, (int32_t)count);
  } else {
    // The entry is held from hi on.  A thread is done at hi, once its entry
    // is `absorb` (which loops to itself), or once it reads `absorb` in
    // out[s], which another segment stored and which is final (a stale read
    // only delays the stop; the read is issued before the tile's steps).  A
    // done thread stops stepping, and the block stops staging once every
    // thread is done (the scan's vote).
    bool done = i >= n;
    auto scan = [&](const uint8_t* cur, int t0, int rows) -> bool {
      if (!done) {
        const bool stored = amt::ld_relaxed(out + i) == (int32_t)absorb;
        const uint8_t* col = cur + threadIdx.x;
        const int r = min(rows, hi - t0);
#pragma unroll 4
        for (int j = 0; j < r; ++j) step(col[j * amt::kRowBytes]);
        done = stored || t0 + rows >= hi || step.carry == absorb;
      }
      return done;
    };
    amt::staged_scan(tiles, tile, streams + s_base, S, n, i0, seg.start, stop, rep, scan);
    if (i < n) {
      if (step.carry == absorb) {
        atomicExch(out + i, (int32_t)absorb);
      } else {
        const int v = min(vend[s_base + i], T);
        if (v > seg.lo && v <= seg.hi)  // this segment's own range holds step v - 1
          atomicCAS(out + i, 0, (int32_t)step.carry);
      }
    }
  }
}

bool args_ok(int T, int S, int table_words, int packing, int state_bits) {
  return T >= 0 && S > 0 && table_words > 0 && table_words <= amt::kMaxDenseTableWords &&
         state_bits > 0 && state_bits < 32 && (packing == 1 || packing == 2);
}

template <int PACKING, int MODE>
int launch_dense(int T, int S, int table_words, int segments, int n, cudaStream_t stream,
                 const void* streams, const void* classmap, const void* table, const void* warm,
                 const void* vend, int state_bits, int overlap, int s_base, uint32_t absorb,
                 void* out) {
  const size_t smem =
      (size_t)amt::dense_words(table_words) * sizeof(uint32_t) + amt::kStageBytes;
  auto kernel = dense_count_kernel<PACKING, MODE>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3((n + kThreads - 1) / kThreads, segments), kThreads, smem, stream>>>(
      (const uint8_t*)streams, T, S, (const int32_t*)classmap, (const int32_t*)table,
      table_words, (const int32_t*)warm, (const int32_t*)vend, state_bits, overlap, segments,
      amt::kTile, s_base, n, absorb, (int32_t*)out);
  return (int)cudaGetLastError();
}

}  // namespace

// out int32 [S], zeroed by the caller.  Each stream is cut into `segments`
// pieces (`overlap` is the stream plan's warm-up; with segments = 1 it is not
// read).  Launch on `stream` (a cudaStream_t).  Returns the cudaError_t of
// the launch; the kernel runs asynchronously.
extern "C" int amt_dense_count(const void* streams, int T, int S,
                               const void* classmap, const void* table,
                               int table_words, const void* warm,
                               const void* vend, int packing, int state_bits,
                               int overlap, int segments, void* out, void* stream) {
  if (!args_ok(T, S, table_words, packing, state_bits) || overlap < 0 || segments < 1 ||
      segments > kMaxSegments)
    return (int)cudaErrorInvalidValue;
  auto launch = packing == 1 ? launch_dense<1, kCount> : launch_dense<2, kCount>;
  return launch(T, S, table_words, segments, S, (cudaStream_t)stream, streams, classmap, table,
                warm, vend, state_bits, overlap, 0, 0u, out);
}

// B3: out int32 [s1 - s0], filled with the root entry 0 by the caller: the
// final sticky entry of streams [s0, s1), `absorb` iff the stream saw a match
// in [0, vend[s]).  Each stream is cut into `segments` pieces as for B1.
extern "C" int amt_dense_contains(const void* streams, int T, int S, const void* classmap,
                                  const void* table, int table_words, const void* vend,
                                  int packing, int state_bits, int absorb, int s0, int s1,
                                  int overlap, int segments, void* out, void* stream) {
  if (!args_ok(T, S, table_words, packing, state_bits) || s0 < 0 || s1 <= s0 || s1 > S ||
      absorb < 0 || overlap < 0 || segments < 1 || segments > kMaxSegments)
    return (int)cudaErrorInvalidValue;
  auto launch = packing == 1 ? launch_dense<1, kSticky> : launch_dense<2, kSticky>;
  return launch(T, S, table_words, segments, s1 - s0, (cudaStream_t)stream, streams, classmap,
                table, nullptr, vend, state_bits, overlap, s0, (uint32_t)absorb, out);
}

// B5: out int32 [T, S], the packed entry at every step; each of the
// `segments` pieces of every stream writes the rows of its own range.  As
// amt_dense_count otherwise.
extern "C" int amt_dense_states(const void* streams, int T, int S, const void* classmap,
                                const void* table, int table_words, int packing, int state_bits,
                                int overlap, int segments, void* out, void* stream) {
  if (!args_ok(T, S, table_words, packing, state_bits) || overlap < 0 || segments < 1 ||
      segments > kMaxSegments)
    return (int)cudaErrorInvalidValue;
  auto launch = packing == 1 ? launch_dense<1, kStates> : launch_dense<2, kStates>;
  return launch(T, S, table_words, segments, S, (cudaStream_t)stream, streams, classmap, table,
                nullptr, nullptr, state_bits, overlap, 0, 0u, out);
}
