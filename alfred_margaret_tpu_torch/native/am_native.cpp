// Host C++ engine of alfred_margaret_tpu_torch: threaded scans of the dense
// byte DFA ([n_states][256] int32, row-major) and of its byte-class packed
// form, with the same emission semantics as the device kernels (match counts
// per post-byte state), so results are bit-identical.  The port holds every
// device answer against it, and it expands hit bitmaps and replays hit states
// for match extraction.
//
// A copy of the scan, extraction, lowering, splicing, prefilter and host
// bitap parts of alfred_margaret_tpu/native/am_native.cpp: the
// IgnoreCase lowering transducer (am_lower_transform, am_lower_bytes,
// am_lower_ascii, am_is_ascii) lowers haystacks for the lowering path, and
// the Replacer's passes rescan windows (am_scan_segments_hits), splice
// (am_splice, am_splice_mt, am_splice_multi) and drop overlaps
// (am_remove_overlap) here; the cpp backend's prefilter for large needle
// sets (am_prefilter_count, am_prefilter_first) and the host bitap oracle
// (am_bitap_count_mt, am_bitap_first) close the file.
// tests/test_torch_host.py and tests/test_torch_case.py hold each entry point
// against the original's.
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


// Strict streaming decode at data[i]: returns the sequence length (1-4)
// and writes the scalar value, or -1 when data[i] does not start a valid
// minimal sequence (overlong / surrogate / > U+10FFFF / truncated /
// orphan continuation).  Must match utf8.decode_strict exactly — this one
// definition governs every IgnoreCase implementation (scalar oracle,
// vectorized + native transducers, composed case-folding DFA).
static inline int strict_decode(const uint8_t* d, int64_t i, int64_t n,
                                uint32_t* cp) {
  uint8_t b0 = d[i];
  if (b0 < 0x80) {
    *cp = b0;
    return 1;
  }
  if (b0 >= 0xC2 && b0 <= 0xDF) {
    if (i + 1 < n && (d[i + 1] & 0xC0) == 0x80) {
      *cp = ((uint32_t)(b0 & 0x1F) << 6) | (d[i + 1] & 0x3F);
      return 2;
    }
    return -1;
  }
  if (b0 >= 0xE0 && b0 <= 0xEF) {
    if (i + 2 < n) {
      uint8_t d1 = d[i + 1];
      uint8_t lo = (b0 == 0xE0) ? 0xA0 : 0x80;
      uint8_t hi = (b0 == 0xED) ? 0x9F : 0xBF;
      if (d1 >= lo && d1 <= hi && (d[i + 2] & 0xC0) == 0x80) {
        *cp = ((uint32_t)(b0 & 0x0F) << 12) | ((uint32_t)(d1 & 0x3F) << 6) |
              (d[i + 2] & 0x3F);
        return 3;
      }
    }
    return -1;
  }
  if (b0 >= 0xF0 && b0 <= 0xF4) {
    if (i + 3 < n) {
      uint8_t d1 = d[i + 1];
      uint8_t lo = (b0 == 0xF0) ? 0x90 : 0x80;
      uint8_t hi = (b0 == 0xF4) ? 0x8F : 0xBF;
      if (d1 >= lo && d1 <= hi && (d[i + 2] & 0xC0) == 0x80 &&
          (d[i + 3] & 0xC0) == 0x80) {
        *cp = ((uint32_t)(b0 & 0x07) << 18) | ((uint32_t)(d1 & 0x3F) << 12) |
              ((uint32_t)(d[i + 2] & 0x3F) << 6) | (d[i + 3] & 0x3F);
        return 4;
      }
    }
    return -1;
  }
  return -1;
}

// Encode a lowered scalar value; width chosen by value, matching
// utf8.lower_units_np (u64: width in the top byte, bytes little-endian).
static inline uint64_t encode_lowered(uint32_t lc) {
  if (lc < 0x80u) return ((uint64_t)1 << 56) | lc;
  if (lc < 0x800u)
    return ((uint64_t)2 << 56) | (uint64_t)(0xC0 | (lc >> 6)) |
           ((uint64_t)(0x80 | (lc & 0x3F)) << 8);
  if (lc < 0x10000u)
    return ((uint64_t)3 << 56) | (uint64_t)(0xE0 | (lc >> 12)) |
           ((uint64_t)(0x80 | ((lc >> 6) & 0x3F)) << 8) |
           ((uint64_t)(0x80 | (lc & 0x3F)) << 16);
  return ((uint64_t)4 << 56) | (uint64_t)(0xF0 | (lc >> 18)) |
         ((uint64_t)(0x80 | ((lc >> 12) & 0x3F)) << 8) |
         ((uint64_t)(0x80 | ((lc >> 6) & 0x3F)) << 16) |
         ((uint64_t)(0x80 | (lc & 0x3F)) << 24);
}

// Length of the pure-ASCII prefix of the next 64 bytes (0..64).  Lets the
// transducers bulk-lower ASCII runs and pay the scalar decode only for the
// actual non-ASCII unit, instead of re-probing a full 64-byte window after
// every decoded code point (which made mixed text ~30x slower than ASCII).
static inline int64_t ascii_prefix_len64(const uint8_t* p) {
  uint64_t w[8];
  memcpy(w, p, 64);
  for (int t = 0; t < 8; t++) {
    uint64_t m = w[t] & 0x8080808080808080ull;
    if (m) return (int64_t)t * 8 + (__builtin_ctzll(m) >> 3);
  }
  return 64;
}

// UTF-8 simple-lowercase transducer, bit-identical to the vectorized numpy
// path (utils/utf8.py lower_units_np): STRICT STREAMING semantics — only
// minimal encodings of scalar values decode and map through lower_map
// (int32[0x110000]); every other byte (overlong, surrogate, truncated,
// orphan continuation, 0xF5+ lead) passes through unchanged as its own
// unit.  The reference never faces malformed input (Haskell Text is
// well-formed UTF-8, Utf8.hs:17-19); this is our contract for raw bytes.
//
// Outputs: lowered bytes -> out (capacity out_cap, must include >= 8
// slack bytes); per-unit raw byte start -> raw_start; per-unit raw byte
// length -> raw_len; per-unit output byte length -> out_len.  Returns the
// unit count, or -1 if out_cap would overflow.  *out_nbytes receives the
// lowered byte count.
int64_t am_lower_transform(const int32_t* lower_map, const uint64_t* emap,
                           const uint8_t* data, int64_t n, uint8_t* out,
                           int64_t out_cap, int32_t* raw_start,
                           int32_t* raw_len, int32_t* out_len,
                           int64_t* out_nbytes) {
  int64_t n_cps = 0;
  int64_t o = 0;
  int64_t i = 0;
  while (i < n) {
    if (i + 64 <= n) {
      int64_t k = ascii_prefix_len64(data + i);
      if (k) {
        if (o + k > out_cap) return -1;
        for (int64_t t = 0; t < k; t++) {
          uint8_t b = data[i + t];
          out[o + t] = (uint8_t)(b + (((uint8_t)(b - 'A') < 26u) ? 0x20 : 0));
          raw_start[n_cps + t] = (int32_t)(i + t);
          raw_len[n_cps + t] = 1;
          out_len[n_cps + t] = 1;
        }
        i += k;
        o += k;
        n_cps += k;
        continue;
      }
    }
    uint32_t cp;
    int l = strict_decode(data, i, n, &cp);
    if (l < 0) {
      if (o + 1 > out_cap) return -1;
      out[o] = data[i];
      raw_start[n_cps] = (int32_t)i;
      raw_len[n_cps] = 1;
      out_len[n_cps] = 1;
      n_cps++;
      o++;
      i++;
      continue;
    }
    uint64_t e = (cp < 0x10000u) ? emap[cp]
                                 : encode_lowered((uint32_t)lower_map[cp]);
    if (o + 8 > out_cap) return -1;
    memcpy(out + o, &e, 8);
    int ol = (int)(e >> 56);
    raw_start[n_cps] = (int32_t)i;
    raw_len[n_cps] = l;
    out_len[n_cps] = ol;
    n_cps++;
    o += ol;
    i += l;
  }
  *out_nbytes = o;
  return n_cps;
}

// Metadata-free lowercase transducer: same strict-streaming byte semantics
// as am_lower_transform but emits only the lowered bytes — for count /
// containsAny, which never map positions back to raw coordinates.
// ``emap`` is a caller-built BMP table of pre-encoded lowered sequences
// (u64: output length in the top byte, up to 4 UTF-8 bytes little-endian
// below; 8 bytes are always stored, the width advances the cursor).
// Returns 0, or -1 if out_cap (which must include >= 8 slack bytes) would
// overflow.
int32_t am_lower_bytes(const int32_t* lower_map, const uint64_t* emap,
                       const uint8_t* data, int64_t n, uint8_t* out,
                       int64_t out_cap, int64_t* out_nbytes) {
  int64_t i = 0, o = 0;
  while (i < n) {
    if (i + 64 <= n) {
      int64_t k = ascii_prefix_len64(data + i);
      if (k) {
        if (o + k > out_cap) return -1;
        for (int64_t t = 0; t < k; t++) {
          uint8_t b = data[i + t];
          out[o + t] = (uint8_t)(b + (((uint8_t)(b - 'A') < 26u) ? 0x20 : 0));
        }
        i += k;
        o += k;
        continue;
      }
    }
    uint32_t cp;
    int l = strict_decode(data, i, n, &cp);
    if (l < 0) {
      if (o + 1 > out_cap) return -1;
      out[o++] = data[i++];
      continue;
    }
    uint64_t e = (cp < 0x10000u) ? emap[cp]
                                 : encode_lowered((uint32_t)lower_map[cp]);
    if (o + 8 > out_cap) return -1;
    memcpy(out + o, &e, 8);
    o += (int64_t)(e >> 56);
    i += l;
  }
  *out_nbytes = o;
  return 0;
}

// ASCII byte-LUT map (A-Z += 0x20) -- the pure-ASCII fast path.
void am_lower_ascii(const uint8_t* data, int64_t n, uint8_t* out) {
  for (int64_t i = 0; i < n; i++) {
    uint8_t b = data[i];
    out[i] = (b >= 'A' && b <= 'Z') ? (uint8_t)(b + 0x20) : b;
  }
}

// Returns 1 iff all bytes < 0x80.
int32_t am_is_ascii(const uint8_t* data, int64_t n) {
  int64_t i = 0;
  const uint64_t* p = reinterpret_cast<const uint64_t*>(data);
  int64_t words = n / 8;
  uint64_t acc = 0;
  for (int64_t w = 0; w < words; w++) acc |= p[w];
  if (acc & 0x8080808080808080ull) return 0;
  for (i = words * 8; i < n; i++)
    if (data[i] & 0x80) return 0;
  return 1;
}

// ---------------------------------------------------------------------------
// The Replacer's host passes: window rescans, splices and overlap removal.
// ---------------------------------------------------------------------------

// Segmented hit scan: run the DFA over many independent [begin, end) byte
// segments of one buffer, resetting to the root state at each segment
// start, appending (position one past match end, state) per hit.  One call
// replaces thousands of tiny per-window scans in the incremental Replacer
// (windows around splice sites).  Returns the total hit count; writes
// min(total, cap) entries.
int64_t am_scan_segments_hits(const int32_t* delta, const int32_t* match_count,
                              const uint8_t* data, const int64_t* seg_begin,
                              const int64_t* seg_end, int64_t n_segs,
                              int64_t* out_pos, int32_t* out_state,
                              int64_t cap) {
  int64_t o = 0, total = 0;
  for (int64_t s = 0; s < n_segs; s++) {
    int32_t state = 0;
    for (int64_t i = seg_begin[s]; i < seg_end[s]; i++) {
      state = delta[(int64_t)state * 256 + data[i]];
      if (match_count[state] > 0) {
        total++;
        if (o < cap) {
          out_pos[o] = i + 1;
          out_state[o] = state;
          o++;
        }
      }
    }
  }
  return total;
}

// Splice: copy data with each sorted non-overlapping [starts_i, ends_i)
// range replaced by repl (one replacement string per call — a Replacer
// pass replaces a single needle).  out must have capacity
// n + n_sites*repl_len.  Returns bytes written.
int64_t am_splice(const uint8_t* data, int64_t n, const int64_t* starts,
                  const int64_t* ends, int64_t n_sites, const uint8_t* repl,
                  int64_t repl_len, uint8_t* out) {
  int64_t o = 0, prev = 0;
  for (int64_t i = 0; i < n_sites; i++) {
    int64_t s = starts[i];
    memcpy(out + o, data + prev, (size_t)(s - prev));
    o += s - prev;
    memcpy(out + o, repl, (size_t)repl_len);
    o += repl_len;
    prev = ends[i];
  }
  memcpy(out + o, data + prev, (size_t)(n - prev));
  return o + (n - prev);
}

// Threaded splice: same contract as am_splice.  Per-site output offsets
// follow from one serial prefix pass over the (constant-delta) sites, after
// which every inter-site segment copies independently — the splice is then
// memory-bandwidth-bound instead of single-core memcpy-bound (it dominates
// Replacer.run wall time at config-4 densities).
int64_t am_splice_mt(const uint8_t* data, int64_t n, const int64_t* starts,
                     const int64_t* ends, int64_t n_sites, const uint8_t* repl,
                     int64_t repl_len, uint8_t* out, int32_t n_threads) {
  if (n_threads <= 1 || n_sites == 0 || n < (int64_t)n_threads * (1 << 20))
    return am_splice(data, n, starts, ends, n_sites, repl, repl_len, out);
  std::vector<int64_t> off(n_sites + 1);
  int64_t shift = 0;
  for (int64_t i = 0; i < n_sites; i++) {
    off[i] = shift;
    shift += repl_len - (ends[i] - starts[i]);
  }
  off[n_sites] = shift;
  int64_t chunk = (n_sites + n_threads - 1) / n_threads;
  std::vector<std::thread> threads;
  for (int t = 0; t < n_threads; t++) {
    threads.emplace_back([&, t]() {
      int64_t i0 = (int64_t)t * chunk, i1 = std::min(n_sites, i0 + chunk);
      for (int64_t i = i0; i < i1; i++) {
        int64_t prev = i ? ends[i - 1] : 0;
        int64_t o = prev + off[i];
        memcpy(out + o, data + prev, (size_t)(starts[i] - prev));
        memcpy(out + o + (starts[i] - prev), repl, (size_t)repl_len);
      }
      if (t == n_threads - 1) {  // tail after the last site
        int64_t prev = ends[n_sites - 1];
        memcpy(out + prev + off[n_sites], data + prev, (size_t)(n - prev));
      }
    });
  }
  for (auto& th : threads) th.join();
  return n + shift;
}

// Multi-replacement splice: like am_splice_mt but each site i carries its
// own replacement string repl_blob[repl_off[rid[i]] .. repl_off[rid[i]+1])
// (the Replacer's batched no-interaction fast path replaces ALL priorities
// in one pass).  Sites sorted by start, non-overlapping.  Returns bytes
// written.
int64_t am_splice_multi(const uint8_t* data, int64_t n, const int64_t* starts,
                        const int64_t* ends, int64_t n_sites,
                        const uint8_t* repl_blob, const int64_t* repl_off,
                        const int32_t* rid, uint8_t* out, int32_t n_threads) {
  std::vector<int64_t> off(n_sites + 1);
  int64_t shift = 0;
  for (int64_t i = 0; i < n_sites; i++) {
    off[i] = shift;
    int64_t rl = repl_off[rid[i] + 1] - repl_off[rid[i]];
    shift += rl - (ends[i] - starts[i]);
  }
  off[n_sites] = shift;
  if (n_threads < 1) n_threads = 1;
  if (n_sites == 0 || n < (int64_t)n_threads * (1 << 20)) n_threads = 1;
  int64_t chunk = (n_sites + n_threads - 1) / n_threads;
  std::vector<std::thread> threads;
  auto work = [&](int t) {
    int64_t i0 = (int64_t)t * chunk, i1 = std::min(n_sites, i0 + chunk);
    for (int64_t i = i0; i < i1; i++) {
      int64_t prev = i ? ends[i - 1] : 0;
      int64_t o = prev + off[i];
      memcpy(out + o, data + prev, (size_t)(starts[i] - prev));
      o += starts[i] - prev;
      int64_t rb = repl_off[rid[i]];
      int64_t rl = repl_off[rid[i] + 1] - rb;
      memcpy(out + o, repl_blob + rb, (size_t)rl);
    }
    if (t == n_threads - 1) {
      int64_t prev = n_sites ? ends[n_sites - 1] : 0;
      memcpy(out + prev + off[n_sites], data + prev, (size_t)(n - prev));
    }
  };
  if (n_threads == 1) {
    work(0);
  } else {
    for (int t = 0; t < n_threads; t++) threads.emplace_back(work, t);
    for (auto& th : threads) th.join();
  }
  return n + shift;
}

// Greedy leftmost-wins overlap removal over (start, end) pairs already
// sorted ascending (removeOverlap, Replacer.hs:191-198): keep a match iff
// its start is at/after the previous kept end.  Returns the kept count.
int64_t am_remove_overlap(const int64_t* starts, const int64_t* ends,
                          int64_t n, int64_t* kept_starts,
                          int64_t* kept_ends) {
  int64_t k = 0;
  int64_t prev_end = -1;
  for (int64_t i = 0; i < n; i++) {
    if (starts[i] >= prev_end) {
      kept_starts[k] = starts[i];
      kept_ends[k] = ends[i];
      prev_end = ends[i];
      k++;
    }
  }
  return k;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Prefilter-verify engine for large needle sets (all needles >= 5 bytes).
//
// The dense-DFA scan is latency-bound on its per-byte table load; for 10k+
// needle sets the table blows the caches and throughput collapses (~0.3-1
// GB/s).  But with min needle length >= 5 every match START must begin with
// some needle's 5-byte prefix, and on realistic byte distributions that is
// a rare event — so a rolling 5-byte window probed against an L1-resident
// blocked Bloom filter skips ~99% of positions, and only candidates touch
// the exact prefix map + tail memcmp.  Counts are (start, needle)
// occurrences == the AC engines' (end, needle) totals, duplicates and
// overlaps included.  (Role analogue: the reference counts all matches via
// its AC fold, benchmark/haskell/app/Main.hs:67-76; this is the
// cache-conscious host path for very large needle sets.)
// ---------------------------------------------------------------------------

namespace prefilter {

static inline uint64_t mix5(uint64_t w) {
  // 5 significant bytes, one 64-bit multiply: the HIGH bits of w * odd
  // constant are well mixed (Knuth multiplicative hashing) — the filter
  // loop is latency-sensitive, so only bits >= 24 may be used downstream.
  return w * 0x9E3779B97F4A7C15ull;
}

struct Tables {
  const uint32_t* bloom;   // [bloom_words], power of two
  uint32_t bloom_mask;     // bloom_words - 1
  const uint64_t* keys;    // [slots] 5-byte prefix keys (~0 = empty)
  const int32_t* grp_off;  // [slots + 1] CSR into grp_needles
  const int32_t* grp_needles;  // needle ids, duplicates listed
  uint32_t slot_mask;      // slots - 1
  const int32_t* nb_off;   // [n_needles + 1] CSR into nb_bytes
  const uint8_t* nb_bytes; // needle bytes, concatenated
};

static const uint64_t KEY_EMPTY = ~0ull;

// Scan starts in [a, b): count (or find first) verified matches.
// stop_at_first: return the first match start (>= 0) or -1; else the count.
static int64_t scan_range(const Tables& t, const uint8_t* data, int64_t n,
                          int64_t a, int64_t b, bool stop_at_first) {
  if (b > n - 4) b = n - 4 < a ? a : n - 4;  // a start needs 5 bytes
  int64_t total = 0;
  uint64_t w = 0;
  // Preload the first 4 window bytes so the loop body is uniform.
  for (int64_t i = a; i < a + 4 && i < n; i++) w = (w >> 8) | ((uint64_t)data[i] << 32);
  for (int64_t p = a; p < b; p++) {
    w = (w >> 8) | ((uint64_t)data[p + 4] << 32);
    uint64_t h = mix5(w);
    uint32_t word = t.bloom[(uint32_t)(h >> 24) & t.bloom_mask];
    uint32_t bit1 = (uint32_t)(h >> 54) & 31, bit2 = (uint32_t)(h >> 59) & 31;
    if ((word & (1u << bit1)) && (word & (1u << bit2))) {
      // Candidate: exact prefix map (open addressing, linear probe).
      uint32_t slot = (uint32_t)(h >> 40) & t.slot_mask;
      while (true) {
        uint64_t k = t.keys[slot];
        if (k == KEY_EMPTY) break;
        if (k == w) {
          for (int32_t gi = t.grp_off[slot]; gi < t.grp_off[slot + 1]; gi++) {
            int32_t nid = t.grp_needles[gi];
            int64_t len = t.nb_off[nid + 1] - t.nb_off[nid];
            if (p + len <= n &&
                (len <= 5 ||
                 memcmp(data + p + 5, t.nb_bytes + t.nb_off[nid] + 5,
                        (size_t)(len - 5)) == 0)) {
              if (stop_at_first) return p;
              total++;
            }
          }
          break;
        }
        slot = (slot + 1) & t.slot_mask;
      }
    }
  }
  return stop_at_first ? -1 : total;
}

}  // namespace prefilter

extern "C" {

// Multithreaded prefilter count over all match starts.
int64_t am_prefilter_count(const uint32_t* bloom, int64_t bloom_words,
                           const uint64_t* keys, const int32_t* grp_off,
                           const int32_t* grp_needles, int64_t slots,
                           const int32_t* nb_off, const uint8_t* nb_bytes,
                           const uint8_t* data, int64_t n, int32_t n_threads) {
  prefilter::Tables t{bloom, (uint32_t)(bloom_words - 1), keys, grp_off,
                      grp_needles, (uint32_t)(slots - 1), nb_off, nb_bytes};
  if (n < 5) return 0;
  if (n_threads <= 1 || n < (int64_t)n_threads * 65536) {
    return prefilter::scan_range(t, data, n, 0, n - 4, false);
  }
  std::vector<std::thread> threads;
  std::vector<int64_t> totals((size_t)n_threads, 0);
  int64_t chunk = (n + n_threads - 1) / n_threads;
  for (int32_t ti = 0; ti < n_threads; ti++) {
    int64_t a = (int64_t)ti * chunk;
    int64_t b = a + chunk < n - 4 ? a + chunk : n - 4;
    if (a >= b) continue;
    threads.emplace_back([&, ti, a, b] {
      totals[(size_t)ti] = prefilter::scan_range(t, data, n, a, b, false);
    });
  }
  for (auto& th : threads) th.join();
  int64_t total = 0;
  for (int64_t v : totals) total += v;
  return total;
}

// First verified match start in [0, n), or -1 (containsAny early exit).
int64_t am_prefilter_first(const uint32_t* bloom, int64_t bloom_words,
                           const uint64_t* keys, const int32_t* grp_off,
                           const int32_t* grp_needles, int64_t slots,
                           const int32_t* nb_off, const uint8_t* nb_bytes,
                           const uint8_t* data, int64_t n) {
  prefilter::Tables t{bloom, (uint32_t)(bloom_words - 1), keys, grp_off,
                      grp_needles, (uint32_t)(slots - 1), nb_off, nb_bytes};
  if (n < 5) return -1;
  return prefilter::scan_range(t, data, n, 0, n - 4, true);
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Bitap (shift-AND) host scan: one bit track per needle ENTRY in a uint64
// register (sum of needle byte lengths <= 64; duplicates get their own
// track, so per-byte counting is a plain popcount of the end bits — no
// multiplicity weights).  Same overlap decomposition as the DFA scans: a
// track is at most max_needle_bytes long, so the register synchronizes
// after overlap = max_needle_bytes - 1 replayed bytes.  Host counterpart
// of ops/bitap_scan.py (the register-automaton kernels B2/B4).

static inline int64_t bitap_interleaved(const uint64_t* btab, uint64_t seed,
                                        uint64_t endmask, const uint8_t* data,
                                        int64_t emit_begin, int64_t emit_end,
                                        int64_t overlap) {
  constexpr int K = kInterleave;
  int64_t n = emit_end - emit_begin;
  if (n <= 0) return 0;
  int64_t total = 0;
  if (n < K * std::max<int64_t>(1024, 4 * overlap)) {
    int64_t w = emit_begin - overlap;
    if (w < 0) w = 0;
    uint64_t d = 0;
    for (int64_t i = w; i < emit_end; i++) {
      d = ((d << 1) | seed) & btab[data[i]];
      if (i >= emit_begin) total += __builtin_popcountll(d & endmask);
    }
    return total;
  }
  int64_t chunk = (n + K - 1) / K;
  int64_t begin[K], end[K];
  uint64_t D[K];
  for (int k = 0; k < K; k++) {
    begin[k] = emit_begin + (int64_t)k * chunk;
    end[k] = begin[k] + chunk;
    if (end[k] > emit_end) end[k] = emit_end;
    if (begin[k] > emit_end) begin[k] = emit_end;
    int64_t w = begin[k] - overlap;
    if (w < 0) w = 0;
    uint64_t d = 0;
    for (int64_t i = w; i < begin[k]; i++) d = ((d << 1) | seed) & btab[data[i]];
    D[k] = d;
  }
  int64_t minlen = end[K - 1] - begin[K - 1];
  for (int64_t t = 0; t < minlen; t++) {
    for (int k = 0; k < K; k++) {
      int64_t i = begin[k] + t;
      D[k] = ((D[k] << 1) | seed) & btab[data[i]];
      total += __builtin_popcountll(D[k] & endmask);
    }
  }
  for (int k = 0; k < K; k++) {
    uint64_t d = D[k];
    for (int64_t i = begin[k] + minlen; i < end[k]; i++) {
      d = ((d << 1) | seed) & btab[data[i]];
      total += __builtin_popcountll(d & endmask);
    }
  }
  return total;
}

extern "C" {

int64_t am_bitap_count_mt(const uint64_t* btab, uint64_t seed,
                          uint64_t endmask, const uint8_t* data, int64_t n,
                          int64_t overlap, int32_t n_threads) {
  if (n_threads <= 1 || n < (int64_t)n_threads * 4096) {
    return bitap_interleaved(btab, seed, endmask, data, 0, n, overlap);
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
      partial[t] =
          bitap_interleaved(btab, seed, endmask, data, emit_begin, emit_end, overlap);
    });
  }
  for (auto& th : threads) th.join();
  int64_t total = 0;
  for (auto p : partial) total += p;
  return total;
}

// First match END (one past the last byte) or -1 (containsAny early exit).
int64_t am_bitap_first(const uint64_t* btab, uint64_t seed, uint64_t endmask,
                       const uint8_t* data, int64_t n) {
  uint64_t d = 0;
  for (int64_t i = 0; i < n; i++) {
    d = ((d << 1) | seed) & btab[data[i]];
    if (d & endmask) return i + 1;
  }
  return -1;
}

}  // extern "C"
