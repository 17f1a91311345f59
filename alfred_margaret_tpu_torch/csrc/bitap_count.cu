// B2 bitap_count: the shift-AND (bitap) count kernel for Hopper.
//
// Replaces the Pallas TPU kernel alfred_margaret_tpu/ops/bitap_scan.py:
// _make_bitap_count_kernel (launched from BitapAcEngine._get_bitap_count_fn),
// CaseSensitive layouts without a trap register.  One thread per stream keeps
// V <= 8 uint32 registers; the byte -> track-mask tables btab[V][256] sit in
// shared memory.
//
// Per stream s, per step t over b = streams[t * S + s]:
//   D[w] = ((D[w] << 1) | seed[w]) & btab[w][b]         for every word w
//   when t >= warm[s]: for every field f of word w (end bit e, weight m)
//     count += ((D[w] >> e) & 1) * m
// and out[s] = count.  The fields of word w are field_bit/field_weight
// [field_start[w], field_start[w + 1]); they are read only on the rare steps
// where D[w] & endmask[w] is non-zero.  Taking the end bits every step gives
// the same integers as the TPU kernel's flush blocks of `unroll` steps, which
// only saved vector operations.  Right-pad bytes are zero and btab[w][0] == 0
// (no needle holds NUL), so the pads clear every register and count nothing.
//
// What bounds it: the registers carry no table load (the mask load depends on
// the input byte only), so a step costs one byte read from device memory plus
// about 3V ALU operations; stream bytes are loaded kChunk steps ahead into
// registers.  One-byte loads at stride S use the memory system poorly, and
// S = 32768 streams give the card only about 248 threads per SM.  Left for
// later: a tiled [S, T] layout with 16-byte loads and more streams per SM.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 16;
constexpr int kMaxWords = 8;
// 30 track bits per word (bit 31 stays clear), at most one field per bit.
constexpr int kMaxFields = kMaxWords * 30;

template <int V>
__global__ void __launch_bounds__(kThreads) bitap_count_kernel(
    const uint8_t* __restrict__ streams, int T, int S,
    const int32_t* __restrict__ btab, const int32_t* __restrict__ seed,
    const int32_t* __restrict__ endmask, const int32_t* __restrict__ field_start,
    const int32_t* __restrict__ field_bit, const int32_t* __restrict__ field_weight,
    int n_fields, const int32_t* __restrict__ warm, int32_t* __restrict__ out) {
  __shared__ uint32_t bt[V * 256];
  __shared__ uint32_t fbit[kMaxFields];
  __shared__ uint32_t fwt[kMaxFields];
  for (int i = threadIdx.x; i < V * 256; i += blockDim.x) bt[i] = (uint32_t)btab[i];
  for (int i = threadIdx.x; i < n_fields; i += blockDim.x) {
    fbit[i] = (uint32_t)field_bit[i];
    fwt[i] = (uint32_t)field_weight[i];
  }
  __syncthreads();

  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= S) return;
  uint32_t sd[V], em[V], D[V];
  int f0[V + 1];
#pragma unroll
  for (int w = 0; w < V; ++w) {
    sd[w] = (uint32_t)seed[w];
    em[w] = (uint32_t)endmask[w];
    D[w] = 0u;
  }
#pragma unroll
  for (int w = 0; w <= V; ++w) f0[w] = field_start[w];
  const int w0 = warm[s];
  const uint8_t* col = streams + s;
  uint32_t count = 0;

  auto step = [&](uint32_t b, int t) {
#pragma unroll
    for (int w = 0; w < V; ++w) D[w] = ((D[w] << 1) | sd[w]) & bt[w * 256 + b];
    if (t >= w0) {
#pragma unroll
      for (int w = 0; w < V; ++w) {
        if (D[w] & em[w]) {
          for (int f = f0[w]; f < f0[w + 1]; ++f) count += ((D[w] >> fbit[f]) & 1u) * fwt[f];
        }
      }
    }
  };

  int t = 0;
  for (; t + kChunk <= T; t += kChunk) {
    uint8_t b[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) b[j] = col[(size_t)(t + j) * S];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) step(b[j], t + j);
  }
  for (; t < T; ++t) step(col[(size_t)t * S], t);
  out[s] = (int32_t)count;
}

template <int V>
void launch(dim3 grid, cudaStream_t st, const uint8_t* sp, int T, int S,
            const int32_t* bt, const int32_t* sd, const int32_t* em,
            const int32_t* fs, const int32_t* fb, const int32_t* fw,
            int n_fields, const int32_t* wp, int32_t* op) {
  bitap_count_kernel<V><<<grid, kThreads, 0, st>>>(sp, T, S, bt, sd, em, fs, fb, fw, n_fields, wp, op);
}

}  // namespace

// Launch on `stream` (a cudaStream_t).  Returns the cudaError_t of the launch;
// the kernel runs asynchronously.
extern "C" int amt_bitap_count(const void* streams, int T, int S,
                               const void* btab, const void* seed,
                               const void* endmask, const void* field_start,
                               const void* field_bit, const void* field_weight,
                               int n_words, int n_fields, const void* warm,
                               void* out, void* stream) {
  if (T < 0 || S <= 0 || n_words < 1 || n_words > kMaxWords || n_fields < 0 ||
      n_fields > kMaxFields)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((S + kThreads - 1) / kThreads);
  cudaStream_t st = (cudaStream_t)stream;
  const uint8_t* sp = (const uint8_t*)streams;
  const int32_t* bt = (const int32_t*)btab;
  const int32_t* sd = (const int32_t*)seed;
  const int32_t* em = (const int32_t*)endmask;
  const int32_t* fs = (const int32_t*)field_start;
  const int32_t* fb = (const int32_t*)field_bit;
  const int32_t* fw = (const int32_t*)field_weight;
  const int32_t* wp = (const int32_t*)warm;
  int32_t* op = (int32_t*)out;
  switch (n_words) {
    case 1: launch<1>(grid, st, sp, T, S, bt, sd, em, fs, fb, fw, n_fields, wp, op); break;
    case 2: launch<2>(grid, st, sp, T, S, bt, sd, em, fs, fb, fw, n_fields, wp, op); break;
    case 3: launch<3>(grid, st, sp, T, S, bt, sd, em, fs, fb, fw, n_fields, wp, op); break;
    case 4: launch<4>(grid, st, sp, T, S, bt, sd, em, fs, fb, fw, n_fields, wp, op); break;
    case 5: launch<5>(grid, st, sp, T, S, bt, sd, em, fs, fb, fw, n_fields, wp, op); break;
    case 6: launch<6>(grid, st, sp, T, S, bt, sd, em, fs, fb, fw, n_fields, wp, op); break;
    case 7: launch<7>(grid, st, sp, T, S, bt, sd, em, fs, fb, fw, n_fields, wp, op); break;
    default: launch<8>(grid, st, sp, T, S, bt, sd, em, fs, fb, fw, n_fields, wp, op); break;
  }
  return (int)cudaGetLastError();
}
