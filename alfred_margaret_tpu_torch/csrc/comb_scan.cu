// B15 comb_count, B16 comb_contains and B17 comb_states: the 32-bit
// row-displacement comb DFA scans for Hopper.
//
// Replace the Pallas TPU kernels alfred_margaret_tpu/ops/comb_scan.py:
// _make_comb_count_kernel (B15, launched from CombPallasAcEngine._get_count_fn),
// _make_comb_contains_kernel (B16, from _get_contains_fn) and
// _make_comb_states_kernel (B17, from _get_states_fn).  They compute what those
// kernels compute, not how: the TPU versions gather 128-lane table rows with
// select chains and split boundary tiles from interior ones; here every
// segment of a stream is one thread and the tables (the class map, the
// comb array and the default rows, at most 48 rows of 128 words together,
// 25 KB) sit in shared memory.
//
// The tables are those of CombMachine: entries are int32 with bit 31 clear,
//   [30..27] match count | [26..13+d] owner residue | [13+d-1..13] default row
//   index | [12..0] base          (d = def_bits, owner_bits = 14 - d).
// A stream carries its state's (base cb, default row df).  One step on byte b:
//   cls = classmap[b];  w = cb + cls
//   v   = comb[w];            hit = w < m_pad && owner(v) == cb mod 2^owner_bits
//   e   = hit ? v : def[df * k + cls]
//   cb  = e & 8191;  df = (e >> 13) & (2^d - 1);  count = e >> 27
// Bases of states without exceptions lie past the comb array (w >= m_pad), so
// the comb index is clamped and the probe is a miss; the default-row index is
// clamped too, so no table contents can read outside shared memory.
//
// B15, per stream s, per step t < vend[s]: count += count(e) while
// warm[s] <= t, from the root's (cb, df); out[s] = count.  The scan stops at
// vend.
// B16, on the sticky view's tables: the same steps over t < vend[s]; out[s] =
// the final base, which is `absorb` iff the stream saw a match.  The absorbing
// state loops to itself, so a scan may stop once it is there.
// B17: every step t < T of every stream; out[t * S + s] = e, the packed entry
// of the state entered at t (its count in bits 30..27, its state through the
// host's inverse base table), also before warm, past vend and on padding.
//
// The design, for Hopper.  The first ports ran one thread per stream, bytes
// loaded from device memory 16 steps ahead into registers, a class-map load
// and the comb and default-row probes a step: 32768 streams gave each SM
// about 8 warps, and each thread waited on device memory once per chunk, in
// series with the chunk's steps, so the kernels were bound by latency with
// too few chains.  comb_seg_kernel, one scan with a compile-time mode (count,
// states or sticky),
//   * splits each stream into `segments` pieces in the kernel (stage.cuh:
//     each scans from the root `overlap` bytes early; B15 counts its own
//     steps and the per-stream sums add with one atomicAdd, B17 writes the
//     rows of its own range, each row exactly once), so a launch runs
//     segments x as many independent chains;
//   * stages the block's bytes into shared memory a tile of 32 steps
//     ahead with 16-byte cp.async copies, double-buffered, so no thread
//     waits on device memory inside the chain;
//   * takes the byte class off the chain: the block translates each staged
//     tile to classes in place, through a byte-packed class map replicated
//     per bank (one wavefront per warp whatever the bytes), before it scans.
// What remains on the chain is the comb and default-row probe of the state,
// two shared-memory loads per step: the SM's shared-memory pipe bounds B15.
// B17 also writes four bytes per stream byte (553.6 MB at config 5's 128
// MiB, 0.165 ms of the 0.207 ms bound at 3.35 TB/s), each warp 128
// contiguous bytes per step, with evict-first stores: the entries are read
// once more, by compact_packed, after the whole array passed through L2.
// Staging a tile's entries in shared memory and writing each row as 16-byte
// stores was slower (0.372 against 0.290 ms, PERF.md section 6): it adds a
// shared-memory store and load per entry to the pipe that bounds the chain.
//
// B16, the sticky mode, combines its segments as B3 (dense_count.cu) and B10
// (comb16_grouped.cu) do.  Segment y scans [max(0, p_y - overlap),
// min(p_{y+1}, vend[s])) from the root with no warm mask: an absorb there is
// a real match in [0, vend), every real match ends in some segment's own
// range, where that segment is in step, and a segment that never absorbs
// runs the plain AC scan, so the owner of step vend[s] - 1 ends in the
// stream's final base.  The wrapper fills out with root_base; a segment that
// reaches `absorb` stores it with atomicExch at the end of that tile, and
// the owner of step vend[s] - 1 stores its base with atomicCAS from
// root_base; vend[s] = 0 keeps root_base.  A thread stops at its stop, once
// its base is `absorb`, or once it reads `absorb` in out[s]: a relaxed load
// issued at a tile's end and compared at the next tile's start (before the
// first: the block's start check, which lets a block whose streams all hold
// `absorb` leave before it loads a table), so that its latency hides behind
// the barriers between tiles (B10's placement, PERF.md section 6).  A block
// stops staging once every thread has stopped (staged_scan's vote).  The
// wrapper refuses root_base = `absorb`: a sticky view's root never absorbs
// (an empty needle matches nothing alone).  What bounds B16: as B15, the
// comb and default-row probes a step, against the bytes up to each stream's
// first match (its vend where it has none); but a warp steps until its last
// stream stops, which on config 5's corpus is most of the steps (PERF.md
// section 6).

#include <cstddef>
#include <cstdint>
#include <climits>
#include <cuda_runtime.h>

#include "stage.cuh"

namespace {

constexpr int kThreads = 128;
// MAX_ROWS (48) rows of 128 int32 words for the comb array and the default
// rows together.
constexpr int kMaxTableWords = 48 * 128;
constexpr int kBaseBits = 13;
constexpr uint32_t kBaseMask = (1u << kBaseBits) - 1u;
constexpr int kCountShift = 27;

struct Comb {
  const uint32_t* comb;  // [m_pad] displaced exception entries
  const uint32_t* def;   // [def_words] default rows, D * k entries used
  uint32_t m_pad, def_last, k, owner_shift, owner_mask, def_mask;

  __device__ __forceinline__ uint32_t def_of(uint32_t e) const {
    return (e >> kBaseBits) & def_mask;
  }
};

// The step from (cb, df) on a byte class already looked up.
__device__ __forceinline__ uint32_t comb_entry_cls(const Comb& c, uint32_t cb, uint32_t df,
                                                   uint32_t cls) {
  const uint32_t w = cb + cls;
  const uint32_t v = c.comb[min(w, c.m_pad - 1u)];
  const uint32_t r = c.def[min(df * c.k + cls, c.def_last)];
  const bool hit = w < c.m_pad && ((v >> c.owner_shift) & c.owner_mask) == (cb & c.owner_mask);
  return hit ? v : r;
}

// The scan's shared memory: the replicated class map, the comb array and the
// default rows (in 32-bit words, rounded up to 16 bytes), then two tiles.
constexpr int kMaxSegments = 64;

inline __host__ __device__ int seg_table_words(int comb_words, int def_words) {
  return (amt::kRepWords + comb_words + def_words + 3) & ~3;
}

size_t seg_smem_bytes(int comb_words, int def_words) {
  return (size_t)seg_table_words(comb_words, def_words) * sizeof(uint32_t) + amt::kStageBytes;
}

// The launchers' argument check: table sizes, the field split and the root.
bool args_ok(int T, int S, int comb_words, int def_words, int k, int owner_bits, int root_base,
             int root_def) {
  return T >= 0 && S > 0 && comb_words > 0 && def_words > 0 &&
         comb_words + def_words <= kMaxTableWords && k >= 1 && k <= 256 && owner_bits >= 1 &&
         owner_bits <= 14 && root_base >= 0 && root_base <= (int)kBaseMask && root_def >= 0 &&
         root_def < (1 << (14 - owner_bits));
}

// The segmented scan's modes (a template parameter).
enum SegMode : int { kSegCount = 0, kSegStates = 1, kSegSticky = 2 };

// Block (x, y) scans streams [128 x, 128 x + 128), segment y.  The count
// (B15) adds the steps [max(p_y, warm[s]), min(p_{y+1}, vend[s])); the
// states (B17) write every row of the segment's own range [p_y, p_{y+1})
// (warm and vend are not read); the sticky scan (B16) steps [max(0, p_y -
// overlap), min(p_{y+1}, vend[s])) and stores its final base (above; warm is
// not read).
template <int kMode>
__global__ void __launch_bounds__(kThreads) comb_seg_kernel(
    const uint8_t* __restrict__ streams, int T, int S, const int32_t* __restrict__ warm,
    const int32_t* __restrict__ vend, const int32_t* __restrict__ classmap,
    const int32_t* __restrict__ comb, int comb_words, const int32_t* __restrict__ deft,
    int def_words, int k, int owner_bits, int overlap, int segments, int tile, uint32_t root_base,
    uint32_t root_def, uint32_t absorb, int32_t* __restrict__ out) {
  // Sticky: out[s] as the thread last read it, before a tile (-1: none).
  int32_t polled = -1;
  if constexpr (kMode == kSegSticky) {
    // A block whose streams all hold the absorbing base already, stored by
    // other segments' blocks, has nothing left to decide: it leaves before
    // it loads a table.
    const int sb = blockIdx.x * kThreads + threadIdx.x;
    if (sb < S) polled = amt::ld_relaxed(out + sb);
    if (__syncthreads_and(sb >= S || polled == (int32_t)absorb)) return;
  }
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ int stop_slot;
  uint32_t* rep = smem;
  uint32_t* cw = rep + amt::kRepWords;
  uint32_t* dw = cw + comb_words;
  amt::load_rep_classes(rep, classmap);
  for (int i = threadIdx.x; i < comb_words; i += blockDim.x) cw[i] = (uint32_t)comb[i];
  for (int i = threadIdx.x; i < def_words; i += blockDim.x) dw[i] = (uint32_t)deft[i];
  const int def_bits = 14 - owner_bits;
  const Comb c{cw, dw, (uint32_t)comb_words, (uint32_t)(def_words - 1), (uint32_t)k,
               (uint32_t)(kBaseBits + def_bits), (1u << owner_bits) - 1u, (1u << def_bits) - 1u};
  uint8_t* tiles = reinterpret_cast<uint8_t*>(smem + seg_table_words(comb_words, def_words));

  const amt::SegSteps seg = amt::segment_steps(blockIdx.y, segments, T, overlap);
  const int s0 = blockIdx.x * kThreads;
  const int s = s0 + threadIdx.x;
  uint32_t cb = root_base, df = root_def;
  if constexpr (kMode == kSegCount) {
    int lo = INT_MAX, hi = 0;  // the steps this thread counts
    if (s < S) {
      lo = max(seg.lo, warm[s]);
      hi = min(seg.hi, min(vend[s], T));
    }
    const int stop = amt::block_stop(&stop_slot, lo, hi);  // also orders the table loads

    uint32_t count = 0;
    auto scan = [&](const uint8_t* tile, int t0, int rows) {
      const uint8_t* col = tile + threadIdx.x;
#pragma unroll 4
      for (int j = 0; j < rows; ++j) {
        const uint32_t e = comb_entry_cls(c, cb, df, col[j * amt::kRowBytes]);
        cb = e & kBaseMask;
        df = c.def_of(e);
        const int t = t0 + j;
        count += (t >= lo && t < hi) ? (e >> kCountShift) : 0u;
      }
    };
    amt::staged_scan(tiles, tile, streams, S, s0, seg.start, stop, rep, scan);
    if (count) atomicAdd(out + s, (int32_t)count);
  } else if constexpr (kMode == kSegSticky) {
    const int hi = s < S ? min(seg.hi, min(vend[s], T)) : 0;  // the steps [seg.start, hi)
    const int stop = amt::block_stop(&stop_slot, seg.start, hi);  // also orders the table loads
    // A thread is done at hi, once its base is `absorb` (which loops to
    // itself: it stores it at the end of that tile), or once the poll read
    // `absorb`, which another segment stored and which is final (a stale
    // read only delays the stop, and the stopped segment's CAS then fails).
    bool done = s >= S;
    auto scan = [&](const uint8_t* tile, int t0, int rows) -> bool {
      if (!done) {
        done = polled == (int32_t)absorb;
        if (!done) {
          const uint8_t* col = tile + threadIdx.x;
          const int r = min(rows, hi - t0);
#pragma unroll 4
          for (int j = 0; j < r; ++j) {
            const uint32_t e = comb_entry_cls(c, cb, df, col[j * amt::kRowBytes]);
            cb = e & kBaseMask;
            df = c.def_of(e);
          }
          done = t0 + rows >= hi || cb == absorb;
          if (cb == absorb) atomicExch(out + s, (int32_t)absorb);
          else if (!done) polled = amt::ld_relaxed(out + s);
        }
      }
      return done;
    };
    amt::staged_scan(tiles, tile, streams, S, s0, seg.start, stop, rep, scan);
    if (s < S && cb != absorb) {
      const int v = min(vend[s], T);
      if (v > seg.lo && v <= seg.hi)  // this segment's own range holds step v - 1
        atomicCAS(out + s, (int32_t)root_base, (int32_t)cb);
    }
  } else {
    __syncthreads();  // the table loads
    // Entries are read once more (compact_packed) after the whole array
    // passed through L2: evict-first stores.
    const int lo = s < S ? seg.lo : INT_MAX;  // the rows this thread writes from
    int32_t* dst = out + s;
    auto scan = [&](const uint8_t* tile, int t0, int rows) {
      const uint8_t* col = tile + threadIdx.x;
#pragma unroll 4
      for (int j = 0; j < rows; ++j) {
        const uint32_t e = comb_entry_cls(c, cb, df, col[j * amt::kRowBytes]);
        cb = e & kBaseMask;
        df = c.def_of(e);
        const int t = t0 + j;
        if (t >= lo) __stcs(dst + (size_t)t * S, (int32_t)e);
      }
    };
    amt::staged_scan(tiles, tile, streams, S, s0, seg.start, seg.hi, rep, scan);
  }
}

template <int kMode>
int launch_seg(size_t smem, int S, int segments, cudaStream_t stream, const void* streams, int T,
               const void* warm, const void* vend, const void* classmap, const void* comb,
               int comb_words, const void* deft, int def_words, int k, int owner_bits,
               int root_base, int root_def, int absorb, int overlap, void* out) {
  auto kernel = comb_seg_kernel<kMode>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + kThreads - 1) / kThreads, segments);
  kernel<<<grid, kThreads, smem, stream>>>(
      (const uint8_t*)streams, T, S, (const int32_t*)warm, (const int32_t*)vend,
      (const int32_t*)classmap, (const int32_t*)comb, comb_words, (const int32_t*)deft,
      def_words, k, owner_bits, overlap, segments, amt::kTile, (uint32_t)root_base,
      (uint32_t)root_def, (uint32_t)absorb, (int32_t*)out);
  return (int)cudaGetLastError();
}

}  // namespace

// B15: out int32 [S], zeroed by the caller; each of the `segments` pieces
// of every stream adds its count (stage.cuh; `overlap` is the stream plan's
// warm-up, and with segments = 1 it is not read).  Launch on `stream` (a
// cudaStream_t); returns the cudaError_t of the launch (also when the
// shared memory asked for is refused); the kernel runs asynchronously.
extern "C" int amt_comb_count(const void* streams, int T, int S, const void* warm,
                              const void* vend, const void* classmap, const void* comb,
                              int comb_words, const void* deft, int def_words, int k,
                              int owner_bits, int root_base, int root_def, int overlap,
                              int segments, void* out, void* stream) {
  if (!args_ok(T, S, comb_words, def_words, k, owner_bits, root_base, root_def) || overlap < 0 ||
      segments < 1 || segments > kMaxSegments)
    return (int)cudaErrorInvalidValue;
  return launch_seg<kSegCount>(seg_smem_bytes(comb_words, def_words), S, segments,
                               (cudaStream_t)stream, streams, T, warm, vend, classmap, comb,
                               comb_words, deft, def_words, k, owner_bits, root_base, root_def,
                               0, overlap, out);
}

// B16: out int32 [S], filled with root_base by the caller: the final base of
// each stream on the sticky view's tables, `absorb` iff the stream saw a
// match in [0, vend[s]); each of the `segments` pieces of every stream
// stores by the protocol above.  As amt_comb_count otherwise.
extern "C" int amt_comb_contains(const void* streams, int T, int S, const void* vend,
                                 const void* classmap, const void* comb, int comb_words,
                                 const void* deft, int def_words, int k, int owner_bits,
                                 int root_base, int root_def, int absorb, int overlap,
                                 int segments, void* out, void* stream) {
  if (!args_ok(T, S, comb_words, def_words, k, owner_bits, root_base, root_def) || absorb < 0 ||
      absorb > (int)kBaseMask || absorb == root_base || overlap < 0 || segments < 1 ||
      segments > kMaxSegments)
    return (int)cudaErrorInvalidValue;
  return launch_seg<kSegSticky>(seg_smem_bytes(comb_words, def_words), S, segments,
                                (cudaStream_t)stream, streams, T, nullptr, vend, classmap, comb,
                                comb_words, deft, def_words, k, owner_bits, root_base, root_def,
                                absorb, overlap, out);
}

// B17: out int32 [T, S], the packed entry at every step; each of the
// `segments` pieces writes the rows of its own range.  As amt_comb_count
// otherwise.
extern "C" int amt_comb_states(const void* streams, int T, int S, const void* classmap,
                               const void* comb, int comb_words, const void* deft,
                               int def_words, int k, int owner_bits, int root_base,
                               int root_def, int overlap, int segments, void* out,
                               void* stream) {
  if (!args_ok(T, S, comb_words, def_words, k, owner_bits, root_base, root_def) || overlap < 0 ||
      segments < 1 || segments > kMaxSegments)
    return (int)cudaErrorInvalidValue;
  return launch_seg<kSegStates>(seg_smem_bytes(comb_words, def_words), S, segments,
                                (cudaStream_t)stream, streams, T, nullptr, nullptr, classmap,
                                comb, comb_words, deft, def_words, k, owner_bits, root_base,
                                root_def, 0, overlap, out);
}
