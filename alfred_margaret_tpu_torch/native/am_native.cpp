// Host C++ engine of alfred_margaret_tpu_torch: threaded scans of the dense
// byte DFA ([n_states][256] int32, row-major) and of its byte-class packed
// form, with the same emission semantics as the device kernels (match counts
// per post-byte state), so results are bit-identical.  The port holds every
// device answer against it, and it expands hit bitmaps and replays hit states
// for match extraction.
//
// A copy of the scan and extraction part of alfred_margaret_tpu/native/
// am_native.cpp (the lowering transducer, splicing and the prefilter stay
// there); tests/test_torch_host.py holds each entry point against the
// original's.
//
// Built with: g++ -O3 -std=c++17 -shared -fPIC (see build.py). Plain C ABI,
// loaded via ctypes.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// State at each of n_pos byte positions, re-derived by a from-root replay
// of the preceding W bytes (the DFA synchronization property: any failure
// chain is at most max_needle_bytes deep, so W = max_needle_bytes suffices
// — ops/pallas_scan.states_at_positions documents the argument).  pos
// holds indices one past the byte whose post-state is wanted, ascending or
// not; positions are independent, so threads split them evenly.
void am_states_at(const int32_t* delta, const uint8_t* data, int64_t n,
                  const int64_t* pos, int64_t n_pos, int32_t w,
                  int32_t* out_states, int32_t n_threads) {
  auto work = [&](int64_t i0, int64_t i1) {
    for (int64_t i = i0; i < i1; i++) {
      int64_t p = pos[i];
      int64_t a = p - w;
      if (a < 0) a = 0;
      int32_t state = 0;
      for (int64_t j = a; j < p && j < n; j++)
        state = delta[(int64_t)state * 256 + data[j]];
      out_states[i] = state;
    }
  };
  if (n_threads <= 1 || n_pos < (int64_t)n_threads * 4096) {
    work(0, n_pos);
    return;
  }
  int64_t chunk = (n_pos + n_threads - 1) / n_threads;
  std::vector<std::thread> threads;
  for (int t = 0; t < n_threads; t++) {
    int64_t i0 = (int64_t)t * chunk;
    threads.emplace_back(work, i0, std::min(n_pos, i0 + chunk));
  }
  for (auto& th : threads) th.join();
}

}  // extern "C" (template helper below needs C++ linkage)

static constexpr int kInterleave = 8;

// K-way interleaved scan of one emit region: the region splits into K
// contiguous substreams, each warmed from ``overlap`` bytes before its
// start (exact — an AC DFA state depends on at most ``overlap`` bytes of
// history, the same argument the thread decomposition uses).  The K
// dependent table-load chains advance round-robin so the core's
// out-of-order window hides load latency: ~3.5x one chain on this host.
// ``emit(k, i, state)`` is called for every emitted byte; within one
// substream k the positions are ascending.
template <typename F>
static inline void scan_interleaved(const int32_t* delta, const uint8_t* data,
                                    int64_t emit_begin, int64_t emit_end,
                                    int64_t overlap, F&& emit) {
  constexpr int K = kInterleave;
  int64_t n = emit_end - emit_begin;
  if (n <= 0) return;
  // Serial when the region is small OR the warm-up would dominate: each of
  // the K substreams re-derives state from `overlap` bytes, so K-way
  // interleaving costs K*overlap extra scanned bytes per region (a
  // long-needle machine with overlap ~ n/K would scan several times the
  // region).
  if (n < K * std::max<int64_t>(1024, 4 * overlap)) {
    int64_t w = emit_begin - overlap;
    if (w < 0) w = 0;
    int32_t s = 0;
    for (int64_t i = w; i < emit_end; i++) {
      s = delta[(int64_t)s * 256 + data[i]];
      if (i >= emit_begin) emit(0, i, s);
    }
    return;
  }
  int64_t chunk = (n + K - 1) / K;
  int64_t begin[K], end[K];
  int32_t st[K];
  for (int k = 0; k < K; k++) {
    begin[k] = emit_begin + (int64_t)k * chunk;
    end[k] = begin[k] + chunk;
    if (end[k] > emit_end) end[k] = emit_end;
    if (begin[k] > emit_end) begin[k] = emit_end;
    int64_t w = begin[k] - overlap;
    if (w < 0) w = 0;
    int32_t s = 0;
    for (int64_t i = w; i < begin[k]; i++) s = delta[(int64_t)s * 256 + data[i]];
    st[k] = s;
  }
  // Substream lengths are non-increasing, so the last one is shortest.
  int64_t minlen = end[K - 1] - begin[K - 1];
  for (int64_t t = 0; t < minlen; t++) {
    for (int k = 0; k < K; k++) {
      int64_t i = begin[k] + t;
      int32_t s = delta[(int64_t)st[k] * 256 + data[i]];
      st[k] = s;
      emit(k, i, s);
    }
  }
  for (int k = 0; k < K; k++) {
    int32_t s = st[k];
    for (int64_t i = begin[k] + minlen; i < end[k]; i++) {
      s = delta[(int64_t)s * 256 + data[i]];
      emit(k, i, s);
    }
  }
}

// ---------------------------------------------------------------------------
// Byte-class premultiplied packed scan — the host analogue of the device
// kernels' entry packing (ops/pallas_scan.py: ``(count << bits) | state*k``)
// plus their byte-class compression (models/byteclass.py).  Two bytes share a
// class iff every state transitions identically on them (e.g. the lowercase
// benchmark machines have 27 classes), so the table shrinks from S*256 to
// S*C int32 entries — the 10k-needle machine drops from 57 MiB (DRAM-random)
// to 6 MiB (cache-resident), measured 2.0x on the interleaved count scan
// (experiments/host_packed_probe.cpp).  Entry layout:
//   entry = next_state * C  |  match_count(next_state) << 24
// so the next gather index is ``(entry & 0xFFFFFF) + cls[byte]`` with no
// multiply on the critical chain, and the count rides the high byte (one
// table load per byte instead of delta + match_count).  Preconditions
// (checked by the Python builder, which falls back to the dense path):
// n_states * C < 2^24 and max match_count < 256.
static constexpr int kInterleaveClass = 12;  // probe: 12 beats 8/16 here

// K-way interleaved class scan; emit(k, i, entry) gets the PACKED entry.
template <typename F>
static inline void scan_class_interleaved(const int32_t* tab, const int32_t* cls,
                                          const uint8_t* data, int64_t emit_begin,
                                          int64_t emit_end, int64_t overlap,
                                          F&& emit) {
  constexpr int K = kInterleaveClass;
  int64_t n = emit_end - emit_begin;
  if (n <= 0) return;
  if (n < K * std::max<int64_t>(1024, 4 * overlap)) {
    int64_t w = emit_begin - overlap;
    if (w < 0) w = 0;
    int32_t e = 0;  // premultiplied root (root == 0 -> 0*C == 0)
    for (int64_t i = w; i < emit_end; i++) {
      e = tab[(e & 0xFFFFFF) + cls[data[i]]];
      if (i >= emit_begin) emit(0, i, e);
    }
    return;
  }
  int64_t chunk = (n + K - 1) / K;
  const uint8_t* p[K];
  int64_t len[K];
  int32_t st[K];
  for (int k = 0; k < K; k++) {
    int64_t b = emit_begin + (int64_t)k * chunk;
    int64_t e = std::min(emit_end, b + chunk);
    if (b > emit_end) b = emit_end;
    p[k] = data + b;
    len[k] = e - b;
    int64_t w = b - overlap;
    if (w < 0) w = 0;
    int32_t s = 0;
    for (int64_t i = w; i < b; i++) s = tab[(s & 0xFFFFFF) + cls[data[i]]];
    st[k] = s;
  }
  int64_t minlen = len[K - 1];
  for (int64_t t = 0; t < minlen; t++) {
    for (int k = 0; k < K; k++) {
      int32_t e = tab[(st[k] & 0xFFFFFF) + cls[p[k][t]]];
      st[k] = e;
      emit(k, (p[k] - data) + t, e);
    }
  }
  for (int k = 0; k < K; k++) {
    int32_t s = st[k];
    for (int64_t t = minlen; t < len[k]; t++) {
      s = tab[(s & 0xFFFFFF) + cls[p[k][t]]];
      emit(k, (p[k] - data) + t, s);
    }
  }
}

extern "C" {

// Class-packed multithreaded count: same overlap-warm-up thread
// decomposition as am_scan_count_mt, one table load per byte.
int64_t am_scan_count_class_mt(const int32_t* tab, const int32_t* cls,
                               const uint8_t* data, int64_t n, int64_t overlap,
                               int32_t n_threads) {
  if (n_threads <= 1 || n < (int64_t)n_threads * 4096) {
    int64_t total = 0;
    scan_class_interleaved(tab, cls, data, 0, n, overlap,
                           [&](int, int64_t, int32_t e) { total += (uint32_t)e >> 24; });
    return total;
  }
  int64_t chunk = (n + n_threads - 1) / n_threads;
  std::vector<int64_t> partial(n_threads, 0);
  std::vector<std::thread> threads;
  for (int t = 0; t < n_threads; t++) {
    threads.emplace_back([&, t]() {
      int64_t emit_begin = (int64_t)t * chunk;
      int64_t emit_end = std::min(n, emit_begin + chunk);
      if (emit_begin >= n) return;
      int64_t total = 0;
      scan_class_interleaved(tab, cls, data, emit_begin, emit_end, overlap,
                             [&](int, int64_t, int32_t e) { total += (uint32_t)e >> 24; });
      partial[t] = total;
    });
  }
  for (auto& th : threads) th.join();
  int64_t total = 0;
  for (auto p : partial) total += p;
  return total;
}

// Class-packed hit scan (the Replacer hot path): append (pos one past match
// end, REAL state id) per matching byte.  The state id is recovered from the
// premultiplied entry by dividing by C — off the per-byte critical path
// (hits only).  Same cap/retry contract as am_scan_hits_mt.
int64_t am_scan_hits_class_mt(const int32_t* tab, const int32_t* cls,
                              int32_t n_classes, const uint8_t* data, int64_t n,
                              int64_t overlap, int32_t n_threads,
                              int64_t* out_pos, int32_t* out_state, int64_t cap) {
  if (n_threads < 1) n_threads = 1;
  if (n < (int64_t)n_threads * 4096) n_threads = 1;
  std::vector<std::vector<std::pair<int64_t, int32_t>>> hits(n_threads);
  int64_t chunk = (n + n_threads - 1) / n_threads;
  std::vector<std::thread> threads;
  for (int t = 0; t < n_threads; t++) {
    threads.emplace_back([&, t]() {
      int64_t emit_begin = (int64_t)t * chunk;
      int64_t emit_end = std::min(n, emit_begin + chunk);
      if (emit_begin >= n) return;
      std::vector<std::pair<int64_t, int32_t>> sub[kInterleaveClass];
      struct Push {
        std::vector<std::pair<int64_t, int32_t>>* sub;
        int32_t C;
        __attribute__((noinline)) void hit(int k, int64_t i, int32_t e) {
          sub[k].emplace_back(i + 1, (e & 0xFFFFFF) / C);
        }
      } push{sub, n_classes};
      scan_class_interleaved(tab, cls, data, emit_begin, emit_end, overlap,
                             [&](int k, int64_t i, int32_t e) {
                               if (__builtin_expect(((uint32_t)e >> 24) != 0, 0))
                                 push.hit(k, i, e);
                             });
      auto& out = hits[t];
      for (auto& v : sub) out.insert(out.end(), v.begin(), v.end());
    });
  }
  for (auto& th : threads) th.join();
  int64_t total = 0, o = 0;
  for (auto& v : hits) total += (int64_t)v.size();
  for (auto& v : hits)
    for (auto& h : v) {
      if (o >= cap) return total;
      out_pos[o] = h.first;
      out_state[o] = h.second;
      o++;
    }
  return total;
}

// Class-packed any-hit scan: am_scan_first_hit over the premultiplied
// packed table (same early-exit contract — the returned position is an
// existence witness, not the leftmost).  The per-thread loop stays serial
// (it may exit within a few bytes); the win is the cache-resident table on
// miss-heavy corpora, which scan to the end.
int64_t am_scan_first_hit_class(const int32_t* tab, const int32_t* cls,
                                const uint8_t* data, int64_t n, int64_t overlap,
                                int32_t n_threads) {
  if (n_threads < 1) n_threads = 1;
  if (n < (int64_t)n_threads * 4096) n_threads = 1;
  std::atomic<bool> found(false);
  std::vector<int64_t> first(n_threads, -1);
  int64_t chunk = (n + n_threads - 1) / n_threads;
  std::vector<std::thread> threads;
  for (int t = 0; t < n_threads; t++) {
    threads.emplace_back([&, t]() {
      int64_t emit_begin = (int64_t)t * chunk;
      int64_t emit_end = std::min(n, emit_begin + chunk);
      if (emit_begin >= n) return;
      int64_t start = emit_begin - overlap;
      if (start < 0) start = 0;
      int32_t e = 0;
      for (int64_t i = start; i < emit_end; i++) {
        e = tab[(e & 0xFFFFFF) + cls[data[i]]];
        if (i >= emit_begin && ((uint32_t)e >> 24) != 0) {
          first[t] = i + 1;
          found.store(true, std::memory_order_relaxed);
          return;
        }
        if ((i & 0xFFF) == 0 && found.load(std::memory_order_relaxed) &&
            i >= emit_begin)
          return;
      }
    });
  }
  for (auto& th : threads) th.join();
  for (int t = 0; t < n_threads; t++)
    if (first[t] >= 0) return first[t];
  return -1;
}

// Class-packed all-values scan (containsAll early exit): identical contract
// to am_scan_all_values; the real state id for the CSR output walk is
// recovered from the premultiplied entry on hits only.
int64_t am_scan_all_values_class(const int32_t* tab, const int32_t* cls,
                                 int32_t n_classes, const int32_t* out_offset,
                                 const int32_t* out_values, int32_t n_values,
                                 const uint8_t* data, int64_t n, int64_t overlap,
                                 int32_t n_threads, uint8_t* out_seen) {
  if (n_threads < 1) n_threads = 1;
  if (n < (int64_t)n_threads * 4096) n_threads = 1;
  std::vector<std::atomic<uint8_t>> shared(n_values);
  for (auto& b : shared) b.store(0, std::memory_order_relaxed);
  std::atomic<int32_t> n_seen(0);
  int64_t chunk = (n + n_threads - 1) / n_threads;
  std::vector<std::thread> threads;
  for (int t = 0; t < n_threads; t++) {
    threads.emplace_back([&, t]() {
      int64_t emit_begin = (int64_t)t * chunk;
      int64_t emit_end = std::min(n, emit_begin + chunk);
      if (emit_begin >= n) return;
      int64_t start = emit_begin - overlap;
      if (start < 0) start = 0;
      std::vector<uint8_t> local(n_values, 0);
      auto merge = [&]() {
        for (int32_t v = 0; v < n_values; v++) {
          if (local[v] && !shared[v].exchange(1, std::memory_order_relaxed))
            n_seen.fetch_add(1, std::memory_order_relaxed);
        }
      };
      int32_t e = 0;
      int64_t next_check = emit_begin + 65536;
      for (int64_t i = start; i < emit_end; i++) {
        e = tab[(e & 0xFFFFFF) + cls[data[i]]];
        if (i >= emit_begin && ((uint32_t)e >> 24) != 0) {
          int32_t state = (e & 0xFFFFFF) / n_classes;
          for (int32_t o = out_offset[state]; o < out_offset[state + 1]; o++)
            local[out_values[o]] = 1;
        }
        if (i >= next_check) {
          next_check = i + 65536;
          merge();
          if (n_seen.load(std::memory_order_relaxed) >= n_values) return;
        }
      }
      merge();
    });
  }
  for (auto& th : threads) th.join();
  for (int32_t v = 0; v < n_values; v++)
    out_seen[v] = shared[v].load(std::memory_order_relaxed);
  return n_seen.load(std::memory_order_relaxed);
}

// Multithreaded count using the same overlap-warm-up decomposition as the
// TPU engines (state depends on at most `overlap` bytes of history), with
// K-way interleaving inside each thread.
int64_t am_scan_count_mt(const int32_t* delta, const int32_t* match_count,
                         int32_t n_states, const uint8_t* data, int64_t n,
                         int64_t overlap, int32_t n_threads) {
  (void)n_states;
  if (n_threads <= 1 || n < (int64_t)n_threads * 4096) {
    int64_t total = 0;
    scan_interleaved(delta, data, 0, n, overlap,
                     [&](int, int64_t, int32_t s) { total += match_count[s]; });
    return total;
  }
  int64_t chunk = (n + n_threads - 1) / n_threads;
  std::vector<int64_t> partial(n_threads, 0);
  std::vector<std::thread> threads;
  for (int t = 0; t < n_threads; t++) {
    threads.emplace_back([&, t]() {
      int64_t emit_begin = (int64_t)t * chunk;
      int64_t emit_end = emit_begin + chunk;
      if (emit_end > n) emit_end = n;
      if (emit_begin >= n) return;
      int64_t total = 0;
      scan_interleaved(delta, data, emit_begin, emit_end, overlap,
                       [&](int, int64_t, int32_t s) { total += match_count[s]; });
      partial[t] = total;
    });
  }
  for (auto& th : threads) th.join();
  int64_t total = 0;
  for (auto p : partial) total += p;
  return total;
}

// Multithreaded per-position states (overlap decomposition + interleaving).
void am_scan_states_mt(const int32_t* delta, int32_t n_states,
                       const uint8_t* data, int64_t n, int64_t overlap,
                       int32_t n_threads, int32_t* out_states) {
  (void)n_states;
  if (n_threads <= 1 || n < (int64_t)n_threads * 4096) {
    scan_interleaved(delta, data, 0, n, overlap,
                     [&](int, int64_t i, int32_t s) { out_states[i] = s; });
    return;
  }
  int64_t chunk = (n + n_threads - 1) / n_threads;
  std::vector<std::thread> threads;
  for (int t = 0; t < n_threads; t++) {
    threads.emplace_back([&, t]() {
      int64_t emit_begin = (int64_t)t * chunk;
      int64_t emit_end = emit_begin + chunk;
      if (emit_end > n) emit_end = n;
      if (emit_begin >= n) return;
      scan_interleaved(delta, data, emit_begin, emit_end, overlap,
                       [&](int, int64_t i, int32_t s) { out_states[i] = s; });
    });
  }
  for (auto& th : threads) th.join();
}

// Any-hit scan: the host analogue of the reference's `Done True`
// early-exit fold (containsAny, Searcher.hs:156-164).  Parallel chunks
// with overlap warm-up; every thread aborts as soon as any thread finds a
// hit, so the returned position is one past SOME match (an aborting
// earlier chunk may skip its own) — callers use it as an existence test.
// Returns -1 when there is no match anywhere.
int64_t am_scan_first_hit(const int32_t* delta, const int32_t* match_count,
                          const uint8_t* data, int64_t n, int64_t overlap,
                          int32_t n_threads) {
  if (n_threads < 1) n_threads = 1;
  if (n < (int64_t)n_threads * 4096) n_threads = 1;
  std::atomic<bool> found(false);
  std::vector<int64_t> first(n_threads, -1);
  int64_t chunk = (n + n_threads - 1) / n_threads;
  std::vector<std::thread> threads;
  for (int t = 0; t < n_threads; t++) {
    threads.emplace_back([&, t]() {
      int64_t emit_begin = (int64_t)t * chunk;
      int64_t emit_end = emit_begin + chunk;
      if (emit_end > n) emit_end = n;
      if (emit_begin >= n) return;
      int64_t start = emit_begin - overlap;
      if (start < 0) start = 0;
      int32_t state = 0;
      for (int64_t i = start; i < emit_end; i++) {
        state = delta[(int64_t)state * 256 + data[i]];
        if (i >= emit_begin && match_count[state] > 0) {
          first[t] = i + 1;
          found.store(true, std::memory_order_relaxed);
          return;
        }
        if ((i & 0xFFF) == 0 && found.load(std::memory_order_relaxed) &&
            i >= emit_begin)
          return;  // an earlier-or-later chunk already found one
      }
    });
  }
  for (auto& th : threads) th.join();
  for (int t = 0; t < n_threads; t++)
    if (first[t] >= 0) return first[t];
  return -1;
}

// All-values scan: the host analogue of the reference's containsAll early
// exit (unseen-needle IntSet emptying, Searcher.hs:173-187).  Each thread
// tracks seen value ids in a local bitmap, merges into a shared atomic
// bitmap every 64 KiB, and every thread stops once the shared count hits
// n_values.  Writes the final seen bitmap (bytes, 0/1) to out_seen;
// returns the number of distinct values seen.
int64_t am_scan_all_values(const int32_t* delta, const int32_t* match_count,
                           const int32_t* out_offset, const int32_t* out_values,
                           int32_t n_values, const uint8_t* data, int64_t n,
                           int64_t overlap, int32_t n_threads,
                           uint8_t* out_seen) {
  if (n_threads < 1) n_threads = 1;
  if (n < (int64_t)n_threads * 4096) n_threads = 1;
  std::vector<std::atomic<uint8_t>> shared(n_values);
  for (auto& b : shared) b.store(0, std::memory_order_relaxed);
  std::atomic<int32_t> n_seen(0);
  int64_t chunk = (n + n_threads - 1) / n_threads;
  std::vector<std::thread> threads;
  for (int t = 0; t < n_threads; t++) {
    threads.emplace_back([&, t]() {
      int64_t emit_begin = (int64_t)t * chunk;
      int64_t emit_end = emit_begin + chunk;
      if (emit_end > n) emit_end = n;
      if (emit_begin >= n) return;
      int64_t start = emit_begin - overlap;
      if (start < 0) start = 0;
      std::vector<uint8_t> local(n_values, 0);
      auto merge = [&]() {
        for (int32_t v = 0; v < n_values; v++) {
          if (local[v] && !shared[v].exchange(1, std::memory_order_relaxed))
            n_seen.fetch_add(1, std::memory_order_relaxed);
        }
      };
      int32_t state = 0;
      int64_t next_check = emit_begin + 65536;
      for (int64_t i = start; i < emit_end; i++) {
        state = delta[(int64_t)state * 256 + data[i]];
        if (i >= emit_begin && match_count[state] > 0) {
          for (int32_t o = out_offset[state]; o < out_offset[state + 1]; o++)
            local[out_values[o]] = 1;
        }
        if (i >= next_check) {
          next_check = i + 65536;
          merge();
          if (n_seen.load(std::memory_order_relaxed) >= n_values) return;
        }
      }
      merge();
    });
  }
  for (auto& th : threads) th.join();
  for (int32_t v = 0; v < n_values; v++)
    out_seen[v] = shared[v].load(std::memory_order_relaxed);
  return n_seen.load(std::memory_order_relaxed);
}

// Hit-only scan: append (position one past the match end, state) for every
// byte whose post-byte state has match_count > 0.  Skips materializing the
// full per-position state array (matches are typically ~1% of positions) —
// the hot path of the multi-pass Replacer.  Returns the total hit count;
// writes min(total, cap) entries (caller retries with a bigger cap — the
// thread-ordered concatenation keeps positions ascending).
int64_t am_scan_hits_mt(const int32_t* delta, const int32_t* match_count,
                        int32_t n_states, const uint8_t* data, int64_t n,
                        int64_t overlap, int32_t n_threads, int64_t* out_pos,
                        int32_t* out_state, int64_t cap) {
  (void)n_states;
  if (n_threads < 1) n_threads = 1;
  if (n < (int64_t)n_threads * 4096) n_threads = 1;
  std::vector<std::vector<std::pair<int64_t, int32_t>>> hits(n_threads);
  int64_t chunk = (n + n_threads - 1) / n_threads;
  std::vector<std::thread> threads;
  for (int t = 0; t < n_threads; t++) {
    threads.emplace_back([&, t]() {
      int64_t emit_begin = (int64_t)t * chunk;
      int64_t emit_end = emit_begin + chunk;
      if (emit_end > n) emit_end = n;
      if (emit_begin >= n) return;
      // Per-substream vectors keep positions ascending under interleaving;
      // concatenating them in k order restores the thread's order.
      std::vector<std::pair<int64_t, int32_t>> sub[kInterleave];
      // The push stays out-of-line so the per-byte emit lambda is small
      // enough to inline into the interleaved scan loop (the inlined
      // emplace body used to push the whole scan to ~2x the count-scan
      // wall on the same data).
      struct Push {
        std::vector<std::pair<int64_t, int32_t>>* sub;
        __attribute__((noinline)) void hit(int k, int64_t i, int32_t s) {
          sub[k].emplace_back(i + 1, s);
        }
      } push{sub};
      scan_interleaved(delta, data, emit_begin, emit_end, overlap,
                       [&](int k, int64_t i, int32_t s) {
                         if (__builtin_expect(match_count[s] > 0, 0))
                           push.hit(k, i, s);
                       });
      auto& out = hits[t];
      for (auto& v : sub) out.insert(out.end(), v.begin(), v.end());
    });
  }
  for (auto& th : threads) th.join();
  int64_t total = 0, o = 0;
  for (auto& v : hits) total += (int64_t)v.size();
  for (auto& v : hits)
    for (auto& h : v) {
      if (o >= cap) return total;
      out_pos[o] = h.first;
      out_state[o] = h.second;
      o++;
    }
  return total;
}

// Expand sparse hit-bitmap words into global end positions (the host side
// of the device match-bitmap compaction; mirrors ops/pallas_scan.
// expand_hit_bits).  Word i covers time steps [32*t_words[i],
// 32*t_words[i]+32) of stream s_idx[i]; bits outside the stream's
// [warm, vend) are dropped; kept bits emit s*L + (t - warm[s]) + 1.
// out must hold >= total popcount(wval) entries; returns the kept count.
// Threaded two-pass (count, prefix, fill) so the output stays dense and
// in word order (bit 0 first within a word, matching the numpy path).
int64_t am_expand_hit_bits(const int64_t* t_words, const int64_t* s_idx,
                           const int32_t* wval, int64_t n_words,
                           const int64_t* warm, const int64_t* vend,
                           int64_t S, int64_t L, int64_t* out,
                           int32_t n_threads) {
  (void)S;
  if (n_threads < 1) n_threads = 1;
  if (n_words < (int64_t)n_threads * 4096) n_threads = 1;
  int64_t chunk = (n_words + n_threads - 1) / n_threads;
  std::vector<int64_t> kept((size_t)n_threads + 1, 0);
  auto count_pass = [&](int t) {
    int64_t i0 = (int64_t)t * chunk, i1 = std::min(n_words, i0 + chunk);
    int64_t k = 0;
    for (int64_t i = i0; i < i1; i++) {
      int64_t s = s_idx[i];
      int64_t t_base = t_words[i] * 32;
      uint32_t bits = (uint32_t)wval[i];
      int64_t w = warm[s], v = vend[s];
      while (bits) {
        int j = __builtin_ctz(bits);
        bits &= bits - 1;
        int64_t tt = t_base + j;
        if (tt >= w && tt < v) k++;
      }
    }
    kept[(size_t)t + 1] = k;
  };
  auto fill_pass = [&](int t) {
    int64_t i0 = (int64_t)t * chunk, i1 = std::min(n_words, i0 + chunk);
    int64_t o = kept[t];
    for (int64_t i = i0; i < i1; i++) {
      int64_t s = s_idx[i];
      int64_t t_base = t_words[i] * 32;
      uint32_t bits = (uint32_t)wval[i];
      int64_t w = warm[s], v = vend[s];
      while (bits) {
        int j = __builtin_ctz(bits);
        bits &= bits - 1;
        int64_t tt = t_base + j;
        if (tt >= w && tt < v) out[o++] = s * L + (tt - w) + 1;
      }
    }
  };
  if (n_threads == 1) {
    count_pass(0);
    fill_pass(0);
    return kept[1];
  }
  {
    std::vector<std::thread> threads;
    for (int t = 0; t < n_threads; t++) threads.emplace_back(count_pass, t);
    for (auto& th : threads) th.join();
  }
  for (int t = 0; t < n_threads; t++) kept[(size_t)t + 1] += kept[t];
  {
    std::vector<std::thread> threads;
    for (int t = 0; t < n_threads; t++) threads.emplace_back(fill_pass, t);
    for (auto& th : threads) th.join();
  }
  return kept[(size_t)n_threads];
}

}  // extern "C"
