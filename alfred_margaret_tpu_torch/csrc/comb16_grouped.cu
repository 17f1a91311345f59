// B9 comb16_count_grouped and B11 comb16_contains_grouped: the fused
// single-launch comb16 scans over G needle groups, for Hopper; B11's
// one-group mode, comb16_contains_base; B10 comb16_contains, the sticky scan
// of one comb16 table set; B13, the comb16 step of B6's hit bitmap
// (matchbits with step "comb16"); B8 comb16_count, the count of one comb16
// table set; and B12 comb16_states, its entry at every step.  One scan
// serves all seven, a compile-time mode of comb16_chunk_kernel: count (B9),
// sticky-any (B11), sticky-base (B11's one-group mode and B10), bits (B13,
// one group), one-count (B8, one group) and states (B12, one group).
//
// Replace the Pallas TPU kernels alfred_margaret_tpu/ops/comb16_scan.py:
// _make_c16_count_kernel_dyn (B9, launched from
// GroupedPallasAcEngine._get_fused_count_fn and, with one group, from the
// sharded engine's count step) and _make_c16_contains_kernel_dyn (B11: with
// n_groups > 1 from _get_fused_contains_fn; with n_groups == 1 from the
// sharded engine's sticky step, parallel/shard.py:616, where it writes each
// stream's final carried base and the absorb compare runs outside it).  The
// TPU kernels walk a sequential grid of G * n_tiles segments, group-major,
// reloading group g's table block for each of its segments and carrying
// counts or hit flags in scratch from one segment to the next.  Here a block
// takes a chunk of groups and 128 streams, and its threads step every group
// of the chunk on each byte (below).
//
// B9, per group g, per stream s, per step t < vend[s]: the scan of B8 on
// group g's tables from its root base gscal[g][0], its count ranges
// gscal[g][1 ..] (padded with 2^BB), counting where warm[s] <= t; the thread
// adds its count to out[s] with one atomicAdd (out zeroed by the wrapper).
// Integer addition is order-free, so the sum is exact.
// B11 (sticky-any), on the groups' sticky tables (CB = 0): the scan of B10
// from gscal[g][0] over t < vend[s]; out[s] = 1 (zeroed by the wrapper) if
// some group reached its absorbing base gscal[g][1], which loops to itself.
// Every writer stores 1, so the races are benign.
// B11's one-group mode (sticky-base, G = 1): the same scan from the root
// base `root`, out[s] = the final base, `absorb` the absorbing base (both
// arguments).  A stream with vend[s] = 0 keeps the root base.
// B10 (sticky-base, G = 1), replacing alfred_margaret_tpu/ops/comb16_scan.py:
// _make_c16_contains_kernel (launched from Comb16PallasAcEngine.
// _get_contains_fn): the same launch on the sticky view's tables of one
// comb16 machine (B11's one-group mode launches it on a shard's group).
// B13 (bits, G = 1), replacing the comb16 step of the Pallas TPU kernel
// alfred_margaret_tpu/ops/pallas_scan.py:make_matchbits_kernel
// (comb16_scan.py:_c16_bits_tables): B9's count of one group from the root
// base `root`, and at every step t bit (t & 31) of bits[(t >> 5) * S + s]
// set iff the step counts (unmasked, as matchbits.cu's steps).  Its
// segments are cut at word boundaries and write every word of their own
// range (stage.cuh word_segment_steps), with no early stop.
// B8 (one-count, G = 1), replacing alfred_margaret_tpu/ops/comb16_scan.py:
// _make_c16_count_kernel (launched from Comb16PallasAcEngine._get_count_fn):
// B13's count without its bitmap, on B9's segments (stage.cuh
// segment_steps), each block stopping at its streams' last vend.  B8's
// tables come as B13's do, the root base and the count ranges as arguments,
// so the ranges sit in registers and each widened entry carries its step's
// count (below) instead of the count mode's compares against the ranges in
// shared memory.
// B12 (states, G = 1), replacing alfred_margaret_tpu/ops/comb16_scan.py:
// _make_c16_states_kernel (launched from Comb16PallasAcEngine._get_states_fn):
// the lookup over the FULL machine's tables (the host maps an entry's base
// back to a state, which the count-minimized tables cannot), from the root
// base `root`, and every step t < T writes out[t * S + s] = e & 0xFFFF with
// no [warm, vend) window (the host picks it).  The block's loader widens the
// full tables as it does B8's, each entry carrying its aux centre and, in its
// low 16 bits, the entry as the tables hold it (count bit, owner, base).
// Each segment (segment_steps) writes every step of its own range [p_y,
// p_{y+1}), before warm, past vend and on padding alike, with evict-first
// stores, and nothing stops early: B17's design (comb_scan.cu) on this scan.
//
// The design, for Hopper.  With a block per
// (group, 128 streams), one dependent chain per thread and the bytes read
// 16 steps ahead from device memory, every step waited on five
// shared-memory loads (class, comb, segment, aux, root) split into several
// bank wavefronts by the lanes' differing states and bytes, and each stream
// byte was read G times.  comb16_chunk_kernel:
//   * a block holds a chunk of `chunk` groups' tables (the wrapper sizes the
//     chunk to a shared-memory budget: config 5's 11 groups go in chunks of
//     at most four, kernels/segments.py B9_CHUNK_BUDGET), and
//     each thread steps its stream's chunk chains on every byte: chunk-way
//     independent chains, each byte read once per block;
//   * the byte's classes come from a byte-packed [ceil(chunk / 4)][256]
//     table, one word for four groups (one group: the class map replicated
//     per bank, one wavefront a warp), off the state's chain;
//   * the block widens the comb, aux and root entries to 32 bits as it loads
//     them, each carrying the aux centre of its base (the segment table's
//     word), so the segment lookup leaves the chain: a group step is three
//     loads, two of them on the chain;
//   * bytes are staged a tile of 32 steps ahead with cp.async and each
//     stream is cut into `segments` pieces (stage.cuh), as for B15.
// The sticky modes scan each segment from max(0, p_i - overlap) up to
// min(p_{i+1}, vend[s]) with no warm mask: an absorb reached there is a real
// match in [0, vend), and every real match ends in some segment's own range,
// where that segment's state is in step (stage.cuh), so it absorbs.  A
// thread stops stepping its whole chunk once one of its groups absorbed (the
// answer is an OR), and a block stops staging once every thread stopped (a
// block-wide vote per tile).  Sticky-base combines the segments exactly under
// any order of the blocks: the launcher fills out with the root base, an
// absorbing segment stores the absorbing base with atomicExch, and the
// segment whose own range holds step vend[s] - 1 (it has read at least
// overlap + 1 bytes there) stores its base with atomicCAS from the root.  A
// sticky-base segment stores the absorbing base at the end of the tile in
// which it absorbed, and a thread stops once a relaxed load of out[s], made
// at the end of the tile before, reads the absorbing base that another
// segment of its stream stored (final; a stale read only delays the stop,
// and the stopped segment's CAS then fails), as B3 does (dense_count.cu); a
// block whose streams all read it before it starts leaves at once.  So where streams
// match early, the later segments' blocks cost a load and a barrier (config
// 2's corpus: PERF.md section 6).
// What remains is the SM's shared-memory pipe: about three wavefronts for
// each of the comb and aux probes of every group step.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "comb16.cuh"
#include "stage.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxChunk = 16;
constexpr int kMaxSegments = 64;
constexpr int kRangeSlots = 8;  // a group's count ranges, padded with 2^BB

// The scan's modes (a template parameter: a run-time mode flag alone slows
// the count, PERF.md section 6).
enum Mode : int {
  kCount = 0, kStickyAny = 1, kStickyBase = 2, kBits = 3, kCountOne = 4, kStates = 5
};

// Shared-memory words of one group's tables: the comb, aux and root
// entries widened to 32-bit words, entry | (aux centre of its base << 16).
inline __host__ __device__ int group_words(int comb_words, int aux_words) {
  return 2 * comb_words + 2 * aux_words + 128;
}

// A block's tables for a chunk of `chunk` groups: the class words (one
// group: the class map replicated per bank; more: [ceil(chunk / 4)][256]
// words, byte r of word (q, b) the class of byte b in group 4q + r), the
// count ranges, then each group's tables; in 32-bit words, rounded up to 16
// bytes.  Two tiles of stream bytes follow.
inline __host__ __device__ int class_words(int chunk) {
  return chunk == 1 ? amt::kRepWords : 256 * ((chunk + 3) / 4);
}
inline __host__ __device__ int chunk_table_words(int chunk, int comb_words, int aux_words) {
  return (class_words(chunk) + chunk * kRangeSlots + chunk * group_words(comb_words, aux_words) +
          3) & ~3;
}
size_t chunk_smem_bytes(int chunk, int comb_words, int aux_words) {
  return (size_t)chunk_table_words(chunk, comb_words, aux_words) * sizeof(uint32_t) +
         amt::kStageBytes;
}

// Block (x, y, z) scans streams [128 x, 128 x + 128), segment y, with
// groups [z * chunk, z * chunk + chunk) (kMaxGc >= chunk), one thread per
// stream stepping every group of the chunk on each byte.  `warm` and `cbit`
// are read by the count and bits modes only; the sticky-any mode takes gscal
// [G, 2].  The bits and one-count modes (G = 1) take the root base in `root`
// and its count ranges in gscal [kC16Ranges] (read into registers, not rng);
// the bits mode writes the words of its segment's own range to `bits`.  The
// states mode (G = 1) takes the root base in `root`, reads neither gscal nor
// warm nor vend, and writes the entries of its segment's own range to `out`.
// The sticky-base mode (G = 1) takes its root and absorbing bases in `root`
// and `absorb`, and reads no gscal.
template <int kMaxGc, int kMode>
__global__ void __launch_bounds__(kThreads) comb16_chunk_kernel(
    const uint8_t* __restrict__ streams, int T, int S, const int32_t* __restrict__ warm,
    const int32_t* __restrict__ vend, int G, const int32_t* __restrict__ classmap,
    const int32_t* __restrict__ comb, int comb_words, const int32_t* __restrict__ aux,
    int aux_words, const int32_t* __restrict__ root_row, const int32_t* __restrict__ segtable,
    const int32_t* __restrict__ gscal, int gscal_width, int bb, int owner_mask, int cbit,
    int overlap, int segments, int chunk, int tile, int32_t* __restrict__ out,
    int32_t* __restrict__ bits, int root, int absorb) {
  // The one-group modes whose root base and ranges are arguments, and whose
  // widened entries carry their step's count.
  constexpr bool kOne = kMode == kBits || kMode == kCountOne;
  constexpr bool kRootArg = kOne || kMode == kStates || kMode == kStickyBase;  // base `root`
  // Sticky-base: out[s] as the thread last read it, before a tile (-1: none).
  int32_t polled = -1;
  if constexpr (kMode == kStickyBase) {
    // A block whose streams all hold the absorbing base already, stored by
    // other segments' blocks, has nothing left to decide: it leaves before
    // it loads a table.
    const int sb = blockIdx.x * kThreads + threadIdx.x;
    const uint32_t ab = (uint32_t)absorb & ((1u << bb) - 1u);
    if (sb < S) polled = amt::ld_relaxed(out + sb);
    if (__syncthreads_and(sb >= S || polled == (int32_t)ab)) return;
  }
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ int stop_slot;
  const int g0 = blockIdx.z * chunk;
  const int gc = min(chunk, G - g0);  // this block's groups
  const int nw = (gc + 3) >> 2;
  const int gw = group_words(comb_words, aux_words);
  const uint32_t bmask = (1u << bb) - 1u, om = (uint32_t)owner_mask;
  const int segshift = bb - 7;
  uint32_t* cls_tab = smem;
  uint32_t* rng = cls_tab + class_words(chunk);
  uint32_t* gt = rng + chunk * kRangeSlots;
  uint8_t* tiles =
      reinterpret_cast<uint8_t*>(smem + chunk_table_words(chunk, comb_words, aux_words));

  if (kMaxGc == 1) {
    amt::load_rep_classes(cls_tab, classmap + (size_t)g0 * 256);
  } else {
    for (int i = threadIdx.x; i < 256 * nw; i += blockDim.x) {
      const int q = i >> 8, b = i & 255;
      uint32_t w = 0;
#pragma unroll
      for (int r = 0; r < 4; ++r)
        if (4 * q + r < gc) w |= ((uint32_t)classmap[(size_t)(g0 + 4 * q + r) * 256 + b] & 0xFFu) << (8 * r);
      cls_tab[i] = w;
    }
  }
  if constexpr (kMode == kCount) {
    for (int i = threadIdx.x; i < gc * kRangeSlots; i += blockDim.x) {
      const int g = i / kRangeSlots, r = i % kRangeSlots;
      rng[i] = r + 1 < gscal_width ? (uint32_t)gscal[(size_t)(g0 + g) * gscal_width + r + 1]
                                   : (1u << bb);
    }
  }
  // The one-group modes' count ranges (gscal holds them), and the count of a
  // step that took entry e.
  uint32_t rr[amt::kC16Ranges];
#pragma unroll
  for (int r = 0; r < amt::kC16Ranges; ++r)
    rr[r] = kOne ? (uint32_t)gscal[r] : (1u << bb);
  auto count_of = [&](uint32_t e) {
    uint32_t n = (e >> 15) & 1u;
#pragma unroll
    for (int r = 0; r < amt::kC16Ranges; ++r) n += (e & bmask) >= rr[r] ? 1u : 0u;
    return n;
  };
  for (int g = 0; g < gc; ++g) {
    uint32_t* tab = gt + g * gw;
    const int32_t* cg = comb + (size_t)(g0 + g) * comb_words;
    const int32_t* ag = aux + (size_t)(g0 + g) * aux_words;
    const int32_t* rg = root_row + (size_t)(g0 + g) * 128;
    const int32_t* sg = segtable + (size_t)(g0 + g) * 128;
    auto widen = [&](uint32_t e) {
      const uint32_t w = e | ((uint32_t)sg[(e & bmask) >> segshift] << 16);
      // The one-group modes also carry the entry's count, saturated at 3, in
      // bits 30-31 (an aux centre is below 2^14: aux holds at most 12288
      // entries).
      return kOne && cbit ? w | (min(count_of(e), 3u) << 30) : w;
    };
    for (int i = threadIdx.x; i < 2 * comb_words; i += blockDim.x)
      tab[i] = widen(((uint32_t)cg[i >> 1] >> ((i & 1) << 4)) & 0xFFFFu);
    for (int i = threadIdx.x; i < 2 * aux_words; i += blockDim.x)
      tab[2 * comb_words + i] = widen(((uint32_t)ag[i >> 1] >> ((i & 1) << 4)) & 0xFFFFu);
    for (int i = threadIdx.x; i < 128; i += blockDim.x)
      tab[2 * comb_words + 2 * aux_words + i] = widen((uint32_t)rg[i] & 0xFFFFu);
  }

  const amt::SegSteps seg = kMode == kBits
                                ? amt::word_segment_steps(blockIdx.y, segments, T, overlap)
                                : amt::segment_steps(blockIdx.y, segments, T, overlap);
  const int s0 = blockIdx.x * kThreads;
  const int s = s0 + threadIdx.x;
  // The count counts the steps [lo, hi); a sticky scan steps [seg.start, hi)
  // and lowers hi to the step after the one where a group absorbed.
  int lo = INT_MAX, hi = 0;
  if constexpr (kMode == kCount || kOne) {
    if (s < S && cbit) {
      lo = max(seg.lo, warm[s]);
      hi = min(seg.hi, min(vend[s], T));
    }
  } else if constexpr (kMode != kStates) {
    if (s < S) {
      lo = seg.start;
      hi = min(seg.hi, min(vend[s], T));
    }
  }
  int stop;
  if constexpr (kMode == kBits || kMode == kStates) {
    stop = seg.hi;  // every word or step of the own range is written: no early stop
    __syncthreads();  // the table loads
  } else {
    stop = amt::block_stop(&stop_slot, lo, hi);  // also orders the table loads
  }

  const int nr = gscal_width - 1;
  const uint32_t lane = threadIdx.x & 31u;
  // r0: the first count range, or the absorbing base of a sticky scan.
  uint32_t cb[kMaxGc], cv[kMaxGc], r0[kMaxGc];
#pragma unroll
  for (int g = 0; g < kMaxGc; ++g) {
    cb[g] = cv[g] = 0;
    r0[g] = 1u << bb;
    if (g < gc) {
      cb[g] = (kRootArg ? (uint32_t)root : (uint32_t)gscal[(size_t)(g0 + g) * gscal_width]) &
              bmask;
      cv[g] = (uint32_t)segtable[(size_t)(g0 + g) * 128 + (cb[g] >> segshift)];
      if constexpr (kMode == kCount)
        r0[g] = rng[g * kRangeSlots];
      else if constexpr (kMode == kStickyBase)
        r0[g] = (uint32_t)absorb & bmask;
      else if constexpr (kMode == kStickyAny)
        r0[g] = (uint32_t)gscal[(size_t)(g0 + g) * gscal_width + 1] & bmask;
    }
  }
  if constexpr (kMode == kCount) {
    uint32_t count = 0;
    auto scan = [&](const uint8_t* tile, int t0, int rows) {
      const uint8_t* col = tile + threadIdx.x;
#pragma unroll 2
      for (int j = 0; j < rows; ++j) {
        const uint32_t b = col[j * amt::kRowBytes];
        uint32_t pw[(kMaxGc + 3) / 4];
        if (kMaxGc == 1) {
          pw[0] = amt::rep_class(cls_tab, b, lane);
        } else {
#pragma unroll
          for (int q = 0; q < (kMaxGc + 3) / 4; ++q) pw[q] = q < nw ? cls_tab[q * 256 + b] : 0u;
        }
        const int t = t0 + j;
        const bool live = t >= lo && t < hi;
#pragma unroll
        for (int g = 0; g < kMaxGc; ++g) {
          if (g >= gc) break;
          const uint32_t cls = (pw[g >> 2] >> ((g & 3) << 3)) & 0xFFu;
          const uint32_t* tab = gt + g * gw;
          // Comb16::entry on the widened tables: the aux centre rides in cv.
          const uint32_t v1 = tab[cb[g] + cls];
          const uint32_t v2 = tab[2 * comb_words + cv[g] + cls];
          const uint32_t vr = tab[2 * comb_words + 2 * aux_words + cls];
          const bool hit1 = (((v1 & 0xFFFFu) >> bb) & om) == (cb[g] & om);
          const bool hit2 = (((v2 & 0xFFFFu) >> bb) & om) == (cv[g] & om);
          const uint32_t v = hit1 ? v1 : (hit2 ? v2 : vr);
          const uint32_t e = v & 0xFFFFu;
          cv[g] = v >> 16;
          cb[g] = e & bmask;
          if (live) {
            uint32_t n = ((e >> 15) & 1u) + (cb[g] >= r0[g] ? 1u : 0u);
            for (int r = 1; r < nr; ++r) n += cb[g] >= rng[g * kRangeSlots + r] ? 1u : 0u;
            count += n;
          }
        }
      }
    };
    amt::staged_scan(tiles, tile, streams, S, s0, seg.start, stop, nullptr, scan);
    if (count) atomicAdd(out + s, (int32_t)count);
  } else if constexpr (kOne) {
    // B13: the count's group step at every step of the segment, each tile
    // one word of each stream (word_segment_steps), its bit set where the
    // step counts; the count as B9's.  B8: the same count, no words.  Tables
    // with CB = 0 count nothing.
    constexpr bool kWords = kMode == kBits;
    const int own = s < S ? seg.lo : INT_MAX;  // the first word this thread stores
    int32_t* dst = bits + s;
    if (kWords && !cbit) {
      for (int t0 = own; t0 < seg.hi; t0 += 32) dst[(size_t)(t0 >> 5) * S] = 0;
      return;
    }
    uint32_t count = 0;
    auto scan = [&](const uint8_t* tile, int t0, int rows) {
      const uint8_t* col = tile + threadIdx.x;
      uint32_t word = 0;
#pragma unroll 2
      for (int j = 0; j < rows; ++j) {
        const uint32_t cls = amt::rep_class(cls_tab, col[j * amt::kRowBytes], lane);
        const uint32_t v1 = gt[cb[0] + cls];
        const uint32_t v2 = gt[2 * comb_words + cv[0] + cls];
        const uint32_t vr = gt[2 * comb_words + 2 * aux_words + cls];
        const bool hit1 = (((v1 & 0xFFFFu) >> bb) & om) == (cb[0] & om);
        const bool hit2 = (((v2 & 0xFFFFu) >> bb) & om) == (cv[0] & om);
        const uint32_t v = hit1 ? v1 : (hit2 ? v2 : vr);
        const uint32_t e = v & 0xFFFFu;
        cv[0] = (v >> 16) & 0x3FFFu;
        cb[0] = e & bmask;
        uint32_t n = v >> 30;
        if (n == 3u) n = count_of(e);  // three matches or more: rare
        if constexpr (kWords) word |= (n != 0u ? 1u : 0u) << j;
        const int t = t0 + j;
        count += (t >= lo && t < hi) ? n : 0u;
      }
      if (kWords && t0 >= own) dst[(size_t)(t0 >> 5) * S] = (int32_t)word;
    };
    amt::staged_scan(tiles, tile, streams, S, s0, seg.start, stop, nullptr, scan);
    if (count) atomicAdd(out + s, (int32_t)count);
  } else if constexpr (kMode == kStates) {
    // B12: the group step at every step of the segment, the entry of each
    // step of its own range stored (evict-first: nothing reads it back here).
    const int own = s < S ? seg.lo : INT_MAX;
    int32_t* dst = out + s;
    auto scan = [&](const uint8_t* tile, int t0, int rows) {
      const uint8_t* col = tile + threadIdx.x;
#pragma unroll 2
      for (int j = 0; j < rows; ++j) {
        const uint32_t cls = amt::rep_class(cls_tab, col[j * amt::kRowBytes], lane);
        const uint32_t v1 = gt[cb[0] + cls];
        const uint32_t v2 = gt[2 * comb_words + cv[0] + cls];
        const uint32_t vr = gt[2 * comb_words + 2 * aux_words + cls];
        const bool hit1 = (((v1 & 0xFFFFu) >> bb) & om) == (cb[0] & om);
        const bool hit2 = (((v2 & 0xFFFFu) >> bb) & om) == (cv[0] & om);
        const uint32_t v = hit1 ? v1 : (hit2 ? v2 : vr);
        const uint32_t e = v & 0xFFFFu;
        cv[0] = v >> 16;
        cb[0] = e & bmask;
        const int t = t0 + j;
        if (t >= own) __stcs(dst + (size_t)t * S, (int32_t)e);
      }
    };
    amt::staged_scan(tiles, tile, streams, S, s0, seg.start, stop, nullptr, scan);
  } else {
    // The same group step; returns whether the thread is done: its steps
    // ran out, a group absorbed or (sticky-base) out[s] holds the absorbing
    // base already.  A sticky-base thread that absorbed stores the absorbing
    // base at the end of that tile (the only one it steps in and absorbs),
    // so that the other segments of its stream see it as early as they can.
    // Otherwise it loads out[s] at the end of a tile and compares it at the
    // start of the next (before the first: the block's start check), so that
    // the load's latency hides behind the block's barriers between tiles
    // instead of stalling the first step.
    auto scan = [&](const uint8_t* tile, int t0, int rows) -> bool {
      const bool live = t0 < hi;
      if (kMode == kStickyBase && live && polled == (int32_t)r0[0]) hi = t0;
      const uint8_t* col = tile + threadIdx.x;
#pragma unroll 2
      for (int j = 0; j < rows; ++j) {
        const int t = t0 + j;
        if (t >= hi) break;
        const uint32_t b = col[j * amt::kRowBytes];
        uint32_t pw[(kMaxGc + 3) / 4];
        if (kMaxGc == 1) {
          pw[0] = amt::rep_class(cls_tab, b, lane);
        } else {
#pragma unroll
          for (int q = 0; q < (kMaxGc + 3) / 4; ++q) pw[q] = q < nw ? cls_tab[q * 256 + b] : 0u;
        }
        bool absorbed = false;
#pragma unroll
        for (int g = 0; g < kMaxGc; ++g) {
          if (g >= gc) break;
          const uint32_t cls = (pw[g >> 2] >> ((g & 3) << 3)) & 0xFFu;
          const uint32_t* tab = gt + g * gw;
          const uint32_t v1 = tab[cb[g] + cls];
          const uint32_t v2 = tab[2 * comb_words + cv[g] + cls];
          const uint32_t vr = tab[2 * comb_words + 2 * aux_words + cls];
          const bool hit1 = (((v1 & 0xFFFFu) >> bb) & om) == (cb[g] & om);
          const bool hit2 = (((v2 & 0xFFFFu) >> bb) & om) == (cv[g] & om);
          const uint32_t v = hit1 ? v1 : (hit2 ? v2 : vr);
          cv[g] = v >> 16;
          cb[g] = v & bmask;
          absorbed |= cb[g] == r0[g];
        }
        if (absorbed) hi = t + 1;
      }
      if (kMode == kStickyBase && live) {
        if (cb[0] == r0[0]) atomicExch(out + s, (int32_t)r0[0]);
        else if (t0 + rows < hi) polled = amt::ld_relaxed(out + s);
      }
      return t0 + rows >= hi;
    };
    amt::staged_scan(tiles, tile, streams, S, s0, seg.start, stop, nullptr, scan);
    if (s < S) {
      bool absorbed = false;
#pragma unroll
      for (int g = 0; g < kMaxGc; ++g) absorbed |= g < gc && cb[g] == r0[g];
      if (kMode == kStickyAny) {
        if (absorbed) out[s] = 1;
      } else if (!absorbed) {  // an absorbing thread stored at the end of its tile
        const int v = min(vend[s], T);
        if (v > seg.lo && v <= seg.hi)  // this segment's own range holds step v - 1
          atomicCAS(out + s, (int32_t)((uint32_t)root & bmask), (int32_t)cb[0]);
      }
    }
  }
}

template <int kMaxGc, int kMode, class... Args>
int launch_chunk(dim3 grid, size_t smem, cudaStream_t stream, Args... args) {
  auto kernel = comb16_chunk_kernel<kMaxGc, kMode>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kThreads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

// The instance whose register arrays hold `chunk` chains.
template <int kMode, class... Args>
int launch_chunk_for(int chunk, dim3 grid, size_t smem, cudaStream_t stream, Args... args) {
  if (chunk <= 1) return launch_chunk<1, kMode>(grid, smem, stream, args...);
  if (chunk <= 2) return launch_chunk<2, kMode>(grid, smem, stream, args...);
  if (chunk <= 4) return launch_chunk<4, kMode>(grid, smem, stream, args...);
  if (chunk <= 8) return launch_chunk<8, kMode>(grid, smem, stream, args...);
  if (chunk <= 12) return launch_chunk<12, kMode>(grid, smem, stream, args...);
  return launch_chunk<16, kMode>(grid, smem, stream, args...);
}

// out[s] = the root base (the sticky-base mode, before its scan).
__global__ void fill_root_kernel(int S, int root, int bb, int32_t* __restrict__ out) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s < S) out[s] = (int32_t)((uint32_t)root & ((1u << bb) - 1u));
}

// The launchers' shared checks: shapes, the field split, segments and chunk.
bool chunk_args_ok(int T, int S, int G, int comb_words, int aux_words, int bb, int owner_mask,
                   int cbit, int overlap, int segments, int chunk) {
  return T >= 0 && S > 0 && G > 0 &&
         amt::comb16_args_ok(comb_words, aux_words, bb, owner_mask, cbit, 0) && overlap >= 0 &&
         segments >= 1 && segments <= kMaxSegments && chunk >= 1 && chunk <= kMaxChunk &&
         (G + chunk - 1) / chunk <= 65535;
}

dim3 chunk_grid(int S, int G, int segments, int chunk) {
  return dim3((S + kThreads - 1) / kThreads, segments, (G + chunk - 1) / chunk);
}

}  // namespace


// B9: out int32 [S], zeroed by the caller; the group tables are [G, ...]
// row-major, gscal [G, gscal_width] with gscal_width - 1 <= 6 count ranges.
// Each block takes `chunk` groups (ceil(G / chunk) chunks) and one of the
// `segments` pieces of its streams (stage.cuh; `overlap` is the stream
// plan's warm-up).  Launch on `stream` (a cudaStream_t); returns the
// cudaError_t of the launch (also when the shared memory asked for is
// refused); the kernel runs asynchronously.
extern "C" int amt_comb16_count_grouped(const void* streams, int T, int S, const void* warm,
                                        const void* vend, int G, const void* classmap,
                                        const void* comb, int comb_words, const void* aux,
                                        int aux_words, const void* root_row,
                                        const void* segtable, const void* gscal,
                                        int gscal_width, int bb, int owner_mask, int cbit,
                                        int overlap, int segments, int chunk, void* out,
                                        void* stream) {
  if (gscal_width < 1 || gscal_width > 1 + amt::kC16Ranges ||
      !chunk_args_ok(T, S, G, comb_words, aux_words, bb, owner_mask, cbit, overlap, segments,
                     chunk))
    return (int)cudaErrorInvalidValue;
  return launch_chunk_for<kCount>(
      chunk, chunk_grid(S, G, segments, chunk), chunk_smem_bytes(chunk, comb_words, aux_words),
      (cudaStream_t)stream, (const uint8_t*)streams, T, S, (const int32_t*)warm,
      (const int32_t*)vend, G, (const int32_t*)classmap, (const int32_t*)comb, comb_words,
      (const int32_t*)aux, aux_words, (const int32_t*)root_row, (const int32_t*)segtable,
      (const int32_t*)gscal, gscal_width, bb, owner_mask, cbit, overlap, segments, chunk,
      amt::kTile, (int32_t*)out, (int32_t*)nullptr, 0, 0);
}

// B11: out int32 [S], zeroed by the caller: 1 where some group's sticky scan
// reached its absorbing base; gscal [G, 2].  As amt_comb16_count_grouped
// otherwise.
extern "C" int amt_comb16_contains_grouped(const void* streams, int T, int S, const void* vend,
                                           int G, const void* classmap, const void* comb,
                                           int comb_words, const void* aux, int aux_words,
                                           const void* root_row, const void* segtable,
                                           const void* gscal, int bb, int owner_mask,
                                           int overlap, int segments, int chunk, void* out,
                                           void* stream) {
  if (!chunk_args_ok(T, S, G, comb_words, aux_words, bb, owner_mask, 0, overlap, segments, chunk))
    return (int)cudaErrorInvalidValue;
  return launch_chunk_for<kStickyAny>(
      chunk, chunk_grid(S, G, segments, chunk), chunk_smem_bytes(chunk, comb_words, aux_words),
      (cudaStream_t)stream, (const uint8_t*)streams, T, S, (const int32_t*)nullptr,
      (const int32_t*)vend, G, (const int32_t*)classmap, (const int32_t*)comb, comb_words,
      (const int32_t*)aux, aux_words, (const int32_t*)root_row, (const int32_t*)segtable,
      (const int32_t*)gscal, 2, bb, owner_mask, 0, overlap, segments, chunk, amt::kTile,
      (int32_t*)out, (int32_t*)nullptr, 0, 0);
}

// B10 and B11's one-group mode: out int32 [S], each stream's final base
// (filled with root_cb here, then combined over the segments), `absorb` iff
// the stream saw a match in [0, vend[s]); the sticky tables of one comb16
// machine or group (classmap [256], comb [comb_words], aux [aux_words],
// root_row and segtable [128]).  As amt_comb16_count_grouped otherwise.
extern "C" int amt_comb16_contains(const void* streams, int T, int S, const void* vend,
                                   const void* classmap, const void* comb, int comb_words,
                                   const void* aux, int aux_words, const void* root_row,
                                   const void* segtable, int bb, int owner_mask, int root_cb,
                                   int absorb, int overlap, int segments, void* out,
                                   void* stream) {
  if (!amt::comb16_args_ok(comb_words, aux_words, bb, owner_mask, 0, root_cb) || absorb < 0 ||
      absorb >= (1 << bb) ||
      !chunk_args_ok(T, S, 1, comb_words, aux_words, bb, owner_mask, 0, overlap, segments, 1))
    return (int)cudaErrorInvalidValue;
  fill_root_kernel<<<(S + kThreads - 1) / kThreads, kThreads, 0, (cudaStream_t)stream>>>(
      S, root_cb, bb, (int32_t*)out);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_chunk<1, kStickyBase>(
      chunk_grid(S, 1, segments, 1), chunk_smem_bytes(1, comb_words, aux_words),
      (cudaStream_t)stream, (const uint8_t*)streams, T, S, (const int32_t*)nullptr,
      (const int32_t*)vend, 1, (const int32_t*)classmap, (const int32_t*)comb, comb_words,
      (const int32_t*)aux, aux_words, (const int32_t*)root_row, (const int32_t*)segtable,
      (const int32_t*)nullptr, 0, bb, owner_mask, 0, overlap, segments, 1, amt::kTile,
      (int32_t*)out, (int32_t*)nullptr, root_cb, absorb);
}

// B13, B6's comb16 step: counts int32 [S], zeroed by the caller; bits int32
// [T / 32, S] (T % 32 == 0), every word written; the tables of
// amt_comb16_count (classmap [256], comb, aux, root_row and segtable [128],
// ranges [kC16Ranges] padded with 2^BB, the field split and the root base).
// Each stream is cut into `segments` pieces at word boundaries (stage.cuh
// word_segment_steps).  As amt_comb16_count_grouped otherwise.
extern "C" int amt_matchbits_comb16(const void* streams, int T, int S, const void* warm,
                                    const void* vend, const void* classmap, const void* comb,
                                    int comb_words, const void* aux, int aux_words,
                                    const void* root_row, const void* segtable,
                                    const void* ranges, int bb, int owner_mask, int cbit,
                                    int root_cb, int overlap, int segments, void* counts,
                                    void* bits, void* stream) {
  if (T % 32 || !amt::comb16_args_ok(comb_words, aux_words, bb, owner_mask, cbit, root_cb) ||
      !chunk_args_ok(T, S, 1, comb_words, aux_words, bb, owner_mask, cbit, overlap, segments, 1))
    return (int)cudaErrorInvalidValue;
  return launch_chunk<1, kBits>(
      chunk_grid(S, 1, segments, 1), chunk_smem_bytes(1, comb_words, aux_words),
      (cudaStream_t)stream, (const uint8_t*)streams, T, S, (const int32_t*)warm,
      (const int32_t*)vend, 1, (const int32_t*)classmap, (const int32_t*)comb, comb_words,
      (const int32_t*)aux, aux_words, (const int32_t*)root_row, (const int32_t*)segtable,
      (const int32_t*)ranges, amt::kC16Ranges, bb, owner_mask, cbit, overlap, segments, 1,
      amt::kTile, (int32_t*)counts, (int32_t*)bits, root_cb, 0);
}

// B12: out int32 [T, S], the 16-bit entry at every step, every one written;
// the full tables of one comb16 machine (classmap [256], comb, aux, root_row
// and segtable [128], the field split and the root base; `cbit` only takes
// part in the check of the split).  Each stream is cut into `segments` pieces
// (stage.cuh segment_steps; `overlap` is the stream plan's warm-up).  As
// amt_comb16_count_grouped otherwise.
extern "C" int amt_comb16_states(const void* streams, int T, int S, const void* classmap,
                                 const void* comb, int comb_words, const void* aux,
                                 int aux_words, const void* root_row, const void* segtable,
                                 int bb, int owner_mask, int cbit, int root_cb, int overlap,
                                 int segments, void* out, void* stream) {
  if (!amt::comb16_args_ok(comb_words, aux_words, bb, owner_mask, cbit, root_cb) ||
      !chunk_args_ok(T, S, 1, comb_words, aux_words, bb, owner_mask, cbit, overlap, segments, 1))
    return (int)cudaErrorInvalidValue;
  return launch_chunk<1, kStates>(
      chunk_grid(S, 1, segments, 1), chunk_smem_bytes(1, comb_words, aux_words),
      (cudaStream_t)stream, (const uint8_t*)streams, T, S, (const int32_t*)nullptr,
      (const int32_t*)nullptr, 1, (const int32_t*)classmap, (const int32_t*)comb, comb_words,
      (const int32_t*)aux, aux_words, (const int32_t*)root_row, (const int32_t*)segtable,
      (const int32_t*)nullptr, 1, bb, owner_mask, cbit, overlap, segments, 1, amt::kTile,
      (int32_t*)out, (int32_t*)nullptr, root_cb, 0);
}

// B8: out int32 [S], zeroed by the caller, the counts of one comb16 table set
// (the tables and scalars of amt_matchbits_comb16).  Each stream is cut into
// `segments` pieces (stage.cuh segment_steps; `overlap` is the stream plan's
// warm-up).  As amt_comb16_count_grouped otherwise.
extern "C" int amt_comb16_count(const void* streams, int T, int S, const void* warm,
                                const void* vend, const void* classmap, const void* comb,
                                int comb_words, const void* aux, int aux_words,
                                const void* root_row, const void* segtable, const void* ranges,
                                int bb, int owner_mask, int cbit, int root_cb, int overlap,
                                int segments, void* out, void* stream) {
  if (!amt::comb16_args_ok(comb_words, aux_words, bb, owner_mask, cbit, root_cb) ||
      !chunk_args_ok(T, S, 1, comb_words, aux_words, bb, owner_mask, cbit, overlap, segments, 1))
    return (int)cudaErrorInvalidValue;
  return launch_chunk<1, kCountOne>(
      chunk_grid(S, 1, segments, 1), chunk_smem_bytes(1, comb_words, aux_words),
      (cudaStream_t)stream, (const uint8_t*)streams, T, S, (const int32_t*)warm,
      (const int32_t*)vend, 1, (const int32_t*)classmap, (const int32_t*)comb, comb_words,
      (const int32_t*)aux, aux_words, (const int32_t*)root_row, (const int32_t*)segtable,
      (const int32_t*)ranges, amt::kC16Ranges, bb, owner_mask, cbit, overlap, segments, 1,
      amt::kTile, (int32_t*)out, (int32_t*)nullptr, root_cb, 0);
}
