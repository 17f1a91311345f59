// The three-tier 16-bit comb lookup of comb16_grouped.cu (B8-B13, which
// widen the entries as they load them): its table sizes, count ranges and
// argument checks.
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

#include <cstdint>

namespace amt {

// MAX_ROWS (48) rows of 128 int32 words for comb and aux together.
constexpr int kC16MaxTableWords = 48 * 128;
// MAX_COUNT16 - 1 count ranges, padded with 2^BB (no base reaches it).
constexpr int kC16Ranges = 6;

// The launchers' argument check: table sizes and the field split.
inline bool comb16_args_ok(int comb_words, int aux_words, int bb, int owner_mask, int cbit,
                           int root_cb) {
  const int ob = owner_mask == 15 ? 4 : owner_mask == 31 ? 5 : -1;
  return comb_words > 0 && aux_words > 0 && comb_words + aux_words <= kC16MaxTableWords &&
         ob > 0 && (cbit == 0 || cbit == 1) && bb >= 8 && bb + ob + cbit == 16 &&
         root_cb >= 0 && root_cb < (1 << bb);
}

}  // namespace amt
