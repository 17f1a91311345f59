// B15 comb_count, B16 comb_contains and B17 comb_states: the 32-bit
// row-displacement comb DFA scans for Hopper.
//
// Replace the Pallas TPU kernels alfred_margaret_tpu/ops/comb_scan.py:
// _make_comb_count_kernel (B15, launched from CombPallasAcEngine._get_count_fn),
// _make_comb_contains_kernel (B16, from _get_contains_fn) and
// _make_comb_states_kernel (B17, from _get_states_fn).  They compute what those
// kernels compute, not how: the TPU versions gather 128-lane table rows with
// select chains and split boundary tiles from interior ones; here every stream
// is one thread and the tables (the class map, the comb array and the default
// rows, at most 48 rows of 128 words together, 25 KB) sit in shared memory.
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
// state loops to itself, so a thread stops reading once it is there.
// B17: every step t < T of every stream; out[t * S + s] = e, the packed entry
// of the state entered at t (its count in bits 30..27, its state through the
// host's inverse base table).
//
// What bounds them: B15 and B16 run a dependent chain of shared-memory loads
// per step (class, then comb and default row), like B8, so they are
// latency-bound, not bound by device memory; B17 also writes four bytes per
// stream byte, coalesced across the warp.  Stream bytes are loaded kChunk
// steps ahead into registers so that the device-memory loads overlap the
// chain.  Left for later: several streams per thread.

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 16;
// MAX_ROWS (48) rows of 128 int32 words for the comb array and the default
// rows together.
constexpr int kMaxTableWords = 48 * 128;
constexpr int kBaseBits = 13;
constexpr uint32_t kBaseMask = (1u << kBaseBits) - 1u;
constexpr int kCountShift = 27;

struct Comb {
  const uint32_t* cm;    // [256] byte -> class
  const uint32_t* comb;  // [m_pad] displaced exception entries
  const uint32_t* def;   // [def_words] default rows, D * k entries used
  uint32_t m_pad, def_last, k, owner_shift, owner_mask, def_mask;

  __device__ __forceinline__ uint32_t entry(uint32_t cb, uint32_t df, uint32_t b) const {
    const uint32_t cls = cm[b];
    const uint32_t w = cb + cls;
    const uint32_t v = comb[min(w, m_pad - 1u)];
    const uint32_t r = def[min(df * k + cls, def_last)];
    const bool hit = w < m_pad && ((v >> owner_shift) & owner_mask) == (cb & owner_mask);
    return hit ? v : r;
  }
  __device__ __forceinline__ uint32_t def_of(uint32_t e) const {
    return (e >> kBaseBits) & def_mask;
  }
};

// Copy the tables into shared memory (every thread of the block takes part;
// the caller synchronises before the first lookup).
__device__ inline Comb load_comb(uint32_t* smem, const int32_t* __restrict__ classmap,
                                 const int32_t* __restrict__ comb, int comb_words,
                                 const int32_t* __restrict__ deft, int def_words, int k,
                                 int owner_bits) {
  uint32_t* cm = smem;
  uint32_t* cw = cm + 256;
  uint32_t* dw = cw + comb_words;
  for (int i = threadIdx.x; i < 256; i += blockDim.x) cm[i] = (uint32_t)classmap[i];
  for (int i = threadIdx.x; i < comb_words; i += blockDim.x) cw[i] = (uint32_t)comb[i];
  for (int i = threadIdx.x; i < def_words; i += blockDim.x) dw[i] = (uint32_t)deft[i];
  const int def_bits = 14 - owner_bits;
  return Comb{cm, cw, dw, (uint32_t)comb_words, (uint32_t)(def_words - 1), (uint32_t)k,
              (uint32_t)(kBaseBits + def_bits), (1u << owner_bits) - 1u, (1u << def_bits) - 1u};
}

size_t smem_bytes(int comb_words, int def_words) {
  return (size_t)(256 + comb_words + def_words) * sizeof(uint32_t);
}

// The launchers' argument check: table sizes, the field split and the root.
bool args_ok(int T, int S, int comb_words, int def_words, int k, int owner_bits, int root_base,
             int root_def) {
  return T >= 0 && S > 0 && comb_words > 0 && def_words > 0 &&
         comb_words + def_words <= kMaxTableWords && k >= 1 && k <= 256 && owner_bits >= 1 &&
         owner_bits <= 14 && root_base >= 0 && root_base <= (int)kBaseMask && root_def >= 0 &&
         root_def < (1 << (14 - owner_bits));
}

__global__ void __launch_bounds__(kThreads) comb_count_kernel(
    const uint8_t* __restrict__ streams, int T, int S, const int32_t* __restrict__ warm,
    const int32_t* __restrict__ vend, const int32_t* __restrict__ classmap,
    const int32_t* __restrict__ comb, int comb_words, const int32_t* __restrict__ deft,
    int def_words, int k, int owner_bits, int root_base, int root_def,
    int32_t* __restrict__ out) {
  extern __shared__ uint32_t smem[];
  const Comb c = load_comb(smem, classmap, comb, comb_words, deft, def_words, k, owner_bits);
  __syncthreads();

  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= S) return;
  const int w0 = warm[s];
  const int v0 = min(vend[s], T);
  const uint8_t* col = streams + s;
  uint32_t cb = (uint32_t)root_base, df = (uint32_t)root_def, count = 0;

  int t = 0;
  for (; t + kChunk <= v0; t += kChunk) {
    uint8_t b[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) b[j] = col[(size_t)(t + j) * S];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      const uint32_t e = c.entry(cb, df, b[j]);
      cb = e & kBaseMask;
      df = c.def_of(e);
      count += (t + j >= w0) ? (e >> kCountShift) : 0u;
    }
  }
  for (; t < v0; ++t) {
    const uint32_t e = c.entry(cb, df, col[(size_t)t * S]);
    cb = e & kBaseMask;
    df = c.def_of(e);
    count += (t >= w0) ? (e >> kCountShift) : 0u;
  }
  out[s] = (int32_t)count;
}

__global__ void __launch_bounds__(kThreads) comb_contains_kernel(
    const uint8_t* __restrict__ streams, int T, int S, const int32_t* __restrict__ vend,
    const int32_t* __restrict__ classmap, const int32_t* __restrict__ comb, int comb_words,
    const int32_t* __restrict__ deft, int def_words, int k, int owner_bits, int root_base,
    int root_def, uint32_t absorb, int32_t* __restrict__ out) {
  extern __shared__ uint32_t smem[];
  const Comb c = load_comb(smem, classmap, comb, comb_words, deft, def_words, k, owner_bits);
  __syncthreads();

  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= S) return;
  const int v0 = min(vend[s], T);
  const uint8_t* col = streams + s;
  uint32_t cb = (uint32_t)root_base, df = (uint32_t)root_def;

  int t = 0;
  for (; t + kChunk <= v0 && cb != absorb; t += kChunk) {
    uint8_t b[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) b[j] = col[(size_t)(t + j) * S];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      const uint32_t e = c.entry(cb, df, b[j]);
      cb = e & kBaseMask;
      df = c.def_of(e);
    }
  }
  for (; t < v0 && cb != absorb; ++t) {
    const uint32_t e = c.entry(cb, df, col[(size_t)t * S]);
    cb = e & kBaseMask;
    df = c.def_of(e);
  }
  out[s] = (int32_t)cb;
}

__global__ void __launch_bounds__(kThreads) comb_states_kernel(
    const uint8_t* __restrict__ streams, int T, int S, const int32_t* __restrict__ classmap,
    const int32_t* __restrict__ comb, int comb_words, const int32_t* __restrict__ deft,
    int def_words, int k, int owner_bits, int root_base, int root_def,
    int32_t* __restrict__ out) {
  extern __shared__ uint32_t smem[];
  const Comb c = load_comb(smem, classmap, comb, comb_words, deft, def_words, k, owner_bits);
  __syncthreads();

  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= S) return;
  const uint8_t* col = streams + s;
  int32_t* dst = out + s;
  uint32_t cb = (uint32_t)root_base, df = (uint32_t)root_def;

  int t = 0;
  for (; t + kChunk <= T; t += kChunk) {
    uint8_t b[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) b[j] = col[(size_t)(t + j) * S];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      const uint32_t e = c.entry(cb, df, b[j]);
      cb = e & kBaseMask;
      df = c.def_of(e);
      dst[(size_t)(t + j) * S] = (int32_t)e;
    }
  }
  for (; t < T; ++t) {
    const uint32_t e = c.entry(cb, df, col[(size_t)t * S]);
    cb = e & kBaseMask;
    df = c.def_of(e);
    dst[(size_t)t * S] = (int32_t)e;
  }
}

}  // namespace

// B15: out int32 [S].  Launch on `stream` (a cudaStream_t); returns the
// cudaError_t of the launch; the kernel runs asynchronously.
extern "C" int amt_comb_count(const void* streams, int T, int S, const void* warm,
                              const void* vend, const void* classmap, const void* comb,
                              int comb_words, const void* deft, int def_words, int k,
                              int owner_bits, int root_base, int root_def, void* out,
                              void* stream) {
  if (!args_ok(T, S, comb_words, def_words, k, owner_bits, root_base, root_def))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((S + kThreads - 1) / kThreads);
  comb_count_kernel<<<grid, kThreads, smem_bytes(comb_words, def_words), (cudaStream_t)stream>>>(
      (const uint8_t*)streams, T, S, (const int32_t*)warm, (const int32_t*)vend,
      (const int32_t*)classmap, (const int32_t*)comb, comb_words, (const int32_t*)deft,
      def_words, k, owner_bits, root_base, root_def, (int32_t*)out);
  return (int)cudaGetLastError();
}

// B16: out int32 [S], the final bases.  As amt_comb_count otherwise.
extern "C" int amt_comb_contains(const void* streams, int T, int S, const void* vend,
                                 const void* classmap, const void* comb, int comb_words,
                                 const void* deft, int def_words, int k, int owner_bits,
                                 int root_base, int root_def, int absorb, void* out,
                                 void* stream) {
  if (!args_ok(T, S, comb_words, def_words, k, owner_bits, root_base, root_def) || absorb < 0 ||
      absorb > (int)kBaseMask)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((S + kThreads - 1) / kThreads);
  comb_contains_kernel<<<grid, kThreads, smem_bytes(comb_words, def_words),
                         (cudaStream_t)stream>>>(
      (const uint8_t*)streams, T, S, (const int32_t*)vend, (const int32_t*)classmap,
      (const int32_t*)comb, comb_words, (const int32_t*)deft, def_words, k, owner_bits,
      root_base, root_def, (uint32_t)absorb, (int32_t*)out);
  return (int)cudaGetLastError();
}

// B17: out int32 [T, S], the packed entry at every step.  As amt_comb_count
// otherwise.
extern "C" int amt_comb_states(const void* streams, int T, int S, const void* classmap,
                               const void* comb, int comb_words, const void* deft,
                               int def_words, int k, int owner_bits, int root_base,
                               int root_def, void* out, void* stream) {
  if (!args_ok(T, S, comb_words, def_words, k, owner_bits, root_base, root_def))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((S + kThreads - 1) / kThreads);
  comb_states_kernel<<<grid, kThreads, smem_bytes(comb_words, def_words), (cudaStream_t)stream>>>(
      (const uint8_t*)streams, T, S, (const int32_t*)classmap, (const int32_t*)comb, comb_words,
      (const int32_t*)deft, def_words, k, owner_bits, root_base, root_def, (int32_t*)out);
  return (int)cudaGetLastError();
}
