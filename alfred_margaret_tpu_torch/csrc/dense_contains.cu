// B3 dense_contains: the sticky (absorbing-state) DFA existence kernel for Hopper.
//
// Replaces the Pallas TPU kernel alfred_margaret_tpu/ops/pallas_scan.py:
// _make_contains_kernel (launched from PallasAcEngine._get_contains_fn and, one
// stream-row segment per launch, _get_contains_seg_fn).  The tables are the
// sticky view's (_StickyView): entering any match state leads to one extra
// state that loops to itself, and no entry carries a count.  As in B1
// (dense_count.cu) every stream is one thread and the packed table sits in
// shared memory.
//
// Per stream s in [s0, s1), per step t < vend[s] over streams[t * S + s]:
//   idx   = sbase + classmap[byte]
//   v     = packing == 1 ? table[idx]
//                        : (table[idx >> 1] >> 16 * (idx & 1)) & 0xFFFF
//   sbase = v & state_mask
// and out[s - s0] = sbase, the final entry; the stream saw a match iff it is
// `absorb` (the absorbing state times k).  The state is held from t = vend[s]
// on, on every step, so right-pad zeros never move it (the TPU kernel holds
// it on boundary tiles only, and lets pads reset a stream that did not hit
// to the root on machines whose zero byte is inert; the hit flag is the same).
// The state cannot leave `absorb`, so a thread stops reading once it is there.
//
// What bounds it: like B1, the dependent chain of two shared-memory loads per
// step, with stream bytes loaded kChunk steps ahead; one fewer ALU operation
// per step than counting, and streams that hit early stop reading.  A range
// [s0, s1) lets the host queue the corpus-ordered segments of the early-exit
// scan as separate launches and read the first segments' answers first.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 16;
// MAX_ROWS (48) rows of 128 int32 entries: 24 KiB of shared memory.
constexpr int kMaxTableWords = 48 * 128;

template <int PACKING>
__device__ __forceinline__ uint32_t lookup(const uint32_t* tab, uint32_t idx) {
  if (PACKING == 1) return tab[idx];
  return (tab[idx >> 1] >> ((idx & 1u) << 4)) & 0xFFFFu;
}

template <int PACKING>
__global__ void __launch_bounds__(kThreads) dense_contains_kernel(
    const uint8_t* __restrict__ streams, int T, int S,
    const int32_t* __restrict__ classmap, const int32_t* __restrict__ table,
    int table_words, const int32_t* __restrict__ vend, int state_bits,
    uint32_t absorb, int s0, int n, int32_t* __restrict__ out) {
  __shared__ uint32_t cm[256];
  extern __shared__ uint32_t tab[];
  for (int i = threadIdx.x; i < 256; i += blockDim.x) cm[i] = (uint32_t)classmap[i];
  for (int i = threadIdx.x; i < table_words; i += blockDim.x) tab[i] = (uint32_t)table[i];
  __syncthreads();

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int s = s0 + i;
  const uint32_t mask = (1u << state_bits) - 1u;
  const int v0 = min(vend[s], T);
  const uint8_t* col = streams + s;
  uint32_t sbase = 0;

  int t = 0;
  for (; t + kChunk <= v0 && sbase != absorb; t += kChunk) {
    uint8_t b[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) b[j] = col[(size_t)(t + j) * S];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) sbase = lookup<PACKING>(tab, sbase + cm[b[j]]) & mask;
  }
  for (; t < v0 && sbase != absorb; ++t)
    sbase = lookup<PACKING>(tab, sbase + cm[col[(size_t)t * S]]) & mask;
  out[i] = (int32_t)sbase;
}

}  // namespace

// Launch over streams [s0, s1) on `stream` (a cudaStream_t); out holds s1 - s0
// entries.  Returns the cudaError_t of the launch; the kernel runs
// asynchronously.
extern "C" int amt_dense_contains(const void* streams, int T, int S,
                                  const void* classmap, const void* table,
                                  int table_words, const void* vend,
                                  int packing, int state_bits, int absorb,
                                  int s0, int s1, void* out, void* stream) {
  if (T < 0 || S <= 0 || table_words <= 0 || table_words > kMaxTableWords ||
      state_bits <= 0 || state_bits >= 32 || (packing != 1 && packing != 2) ||
      s0 < 0 || s1 <= s0 || s1 > S)
    return (int)cudaErrorInvalidValue;
  const int n = s1 - s0;
  const dim3 grid((n + kThreads - 1) / kThreads);
  const size_t smem = (size_t)table_words * sizeof(uint32_t);
  cudaStream_t st = (cudaStream_t)stream;
  const uint8_t* sp = (const uint8_t*)streams;
  const int32_t* cp = (const int32_t*)classmap;
  const int32_t* tp = (const int32_t*)table;
  const int32_t* vp = (const int32_t*)vend;
  int32_t* op = (int32_t*)out;
  if (packing == 1)
    dense_contains_kernel<1><<<grid, kThreads, smem, st>>>(sp, T, S, cp, tp, table_words, vp, state_bits, (uint32_t)absorb, s0, n, op);
  else
    dense_contains_kernel<2><<<grid, kThreads, smem, st>>>(sp, T, S, cp, tp, table_words, vp, state_bits, (uint32_t)absorb, s0, n, op);
  return (int)cudaGetLastError();
}
