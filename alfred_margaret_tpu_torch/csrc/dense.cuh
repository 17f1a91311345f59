// The packed byte-class DFA step shared by B1 (dense_count.cu), B5 (same
// file) and B6's dense step (matchbits.cu).
//
// The tables are those of the dense engine (ops/pallas_scan.py): entries
//   count << state_bits | next_state * k
// one per 32-bit word (packing 1) or two 16-bit entries per word, low half
// first (packing 2), at most MAX_ROWS (48) rows of 128 words.  One step
// from the state's base `carry` on byte class `cls`:
//   v = entry(carry + cls);  carry = v & state_mask;  count = v >> state_bits

#pragma once

#include <cstdint>

#include "stage.cuh"

namespace amt {

// MAX_ROWS (48) rows of 128 int32 entries: 24 KiB of shared memory.
constexpr int kMaxDenseTableWords = 48 * 128;

template <int PACKING>
__device__ __forceinline__ uint32_t dense_lookup(const uint32_t* tab, uint32_t idx) {
  if (PACKING == 1) return tab[idx];
  return (tab[idx >> 1] >> ((idx & 1u) << 4)) & 0xFFFFu;
}

// One step of a stream on a byte class already looked up (the segmented
// scans translate their staged tiles to classes in place): the call returns
// the step's count (B1, B3, B6), entry() the whole packed entry (B5,
// zero-extended from 16 bits at packing 2).  Both carry the same state.
template <int PACKING>
struct DenseStep {
  const uint32_t* tab;
  uint32_t mask;
  int state_bits;
  uint32_t carry;
  __device__ __forceinline__ uint32_t operator()(uint32_t cls) {
    const uint32_t v = dense_lookup<PACKING>(tab, carry + cls);
    carry = v & mask;
    return v >> state_bits;
  }
  __device__ __forceinline__ uint32_t entry(uint32_t cls) {
    const uint32_t v = dense_lookup<PACKING>(tab, carry + cls);
    carry = v & mask;
    return v;
  }
};

// Shared-memory words of the segmented dense scans ahead of their two
// tiles: the replicated class map, then the packed table (rounded up to 16
// bytes).
inline __host__ __device__ int dense_words(int table_words) {
  return (kRepWords + table_words + 3) & ~3;
}

}  // namespace amt
