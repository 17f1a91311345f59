// The three-tier 16-bit comb lookup of B10 (comb16_scan.cu); its argument
// checks and count ranges also serve comb16_grouped.cu (B8, B9, B11, B12 and
// B13, which widen the entries instead).
//
// The tables are those of alfred_margaret_tpu/ops/comb16_scan.py:
// Comb16Machine: a byte class map, the comb and aux tables of 16-bit entries
// (count:CB | owner:OB | base:BB, two to an int32 word, low half first), the
// root row of direct entries and the 128-entry segment table.  A stream
// carries its state's base cb.  One step on byte b:
//   cls = classmap[b]
//   e1  = comb entry cb + cls;   hit1 = ((e1 >> BB) & om) == (cb & om)
//   cbv = segtable[cb >> (BB - 7)]
//   e2  = aux entry cbv + cls;   hit2 = ((e2 >> BB) & om) == (cbv & om)
//   e   = hit1 ? e1 : hit2 ? e2 : root_row[cls];   next cb = e & (2^BB - 1)
// Every field is read as uint32 and masked, so no sign bit leaks in (the TPU
// kernel shifts an int32 arithmetically and masks later).  The TPU kernel
// indexes 128-lane rows mod 128; here the flat tables are indexed directly,
// and the host checks that every probe window base + k lies inside its
// table (ops/comb16_scan.py: Comb16Tables.from_arrays).  All three probes are
// read on every step and selected without a branch, so the threads of a
// warp never diverge.
//
// A step's count (B8, B9, B13): (e >> 15) & 1 plus the count ranges that the
// next base reaches (states with k >= 2 matches sit in base ranges), zero
// when CB = 0.

#pragma once

#include <cstddef>
#include <cstdint>

namespace amt {

// MAX_ROWS (48) rows of 128 int32 words for comb and aux together.
constexpr int kC16MaxTableWords = 48 * 128;
// MAX_COUNT16 - 1 count ranges, padded with 2^BB (no base reaches it).
constexpr int kC16Ranges = 6;

struct Comb16 {
  const uint32_t* cm;    // [256] byte -> class
  const uint32_t* root;  // [128] direct entries
  const uint32_t* seg;   // [128] segment -> aux base of its center
  const uint32_t* comb;  // [comb_words]
  const uint32_t* aux;   // [aux_words]
  uint32_t bb, om;

  __device__ __forceinline__ uint32_t entry(uint32_t cb, uint32_t b) const {
    const uint32_t cls = cm[b];
    const uint32_t w1 = cb + cls;
    const uint32_t e1 = (comb[w1 >> 1] >> ((w1 & 1u) << 4)) & 0xFFFFu;
    const uint32_t cbv = seg[cb >> (bb - 7)];
    const uint32_t w2 = cbv + cls;
    const uint32_t e2 = (aux[w2 >> 1] >> ((w2 & 1u) << 4)) & 0xFFFFu;
    const uint32_t er = root[cls];
    const bool hit1 = ((e1 >> bb) & om) == (cb & om);
    const bool hit2 = ((e2 >> bb) & om) == (cbv & om);
    return hit1 ? e1 : (hit2 ? e2 : er);
  }
};

// Shared-memory words for the tables: class map, root row, segment table,
// comb and aux.
inline size_t comb16_smem_bytes(int comb_words, int aux_words) {
  return (size_t)(256 + 128 + 128 + comb_words + aux_words) * sizeof(uint32_t);
}

// The launchers' argument check: table sizes and the field split.
inline bool comb16_args_ok(int comb_words, int aux_words, int bb, int owner_mask, int cbit,
                           int root_cb) {
  const int ob = owner_mask == 15 ? 4 : owner_mask == 31 ? 5 : -1;
  return comb_words > 0 && aux_words > 0 && comb_words + aux_words <= kC16MaxTableWords &&
         ob > 0 && (cbit == 0 || cbit == 1) && bb >= 8 && bb + ob + cbit == 16 &&
         root_cb >= 0 && root_cb < (1 << bb);
}

// Copy the tables into shared memory (every thread of the block takes part;
// the caller synchronises before the first lookup).
__device__ inline Comb16 load_comb16(uint32_t* smem, const int32_t* __restrict__ classmap,
                                     const int32_t* __restrict__ comb, int comb_words,
                                     const int32_t* __restrict__ aux, int aux_words,
                                     const int32_t* __restrict__ root_row,
                                     const int32_t* __restrict__ segtable, int bb,
                                     int owner_mask) {
  uint32_t* cm = smem;
  uint32_t* root = cm + 256;
  uint32_t* seg = root + 128;
  uint32_t* cw = seg + 128;
  uint32_t* aw = cw + comb_words;
  for (int i = threadIdx.x; i < 256; i += blockDim.x) cm[i] = (uint32_t)classmap[i];
  for (int i = threadIdx.x; i < 128; i += blockDim.x) {
    root[i] = (uint32_t)root_row[i];
    seg[i] = (uint32_t)segtable[i];
  }
  for (int i = threadIdx.x; i < comb_words; i += blockDim.x) cw[i] = (uint32_t)comb[i];
  for (int i = threadIdx.x; i < aux_words; i += blockDim.x) aw[i] = (uint32_t)aux[i];
  return Comb16{cm, root, seg, cw, aw, (uint32_t)bb, (uint32_t)owner_mask};
}

}  // namespace amt
