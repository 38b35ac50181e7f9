// Native host engine: multithreaded byte widening, copy, and flat-BPE scan.
// (Copy of blt_tpu/native/feeder.cpp for the torch port.)
//
// Stand-in for the reference's Rust+Tokio host pipeline
// (reference: blt_core/src/io_handler.rs mmap input, blt_core/src/pipeline.rs
// chunk-parallel workers). The card does the heavy tokenization; this library
// keeps the HOST side (feeding, draining, and the CPU fallback engine) at
// memory bandwidth with a plain pthread worker pool, exposed to Python via
// ctypes (no pybind11 dependency).
//
// The flat-BPE kernel parallelizes the reference's sequential merge scan
// (blt_core/src/tokenizer.rs:61-86) with the same carry decomposition the
// Pallas/JAX kernels use: merge_start[i] = match[i] && !merge_start[i-1]
// alternates over runs of matches, so each thread scans its range assuming
// carry 0, records whether its initial run reaches its end, and the tiny
// per-thread carry chain is resolved sequentially before output compaction.
//
// Build: blt_tpu_torch/native/build.py (g++ -O3 -shared -fPIC -pthread).

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

inline int clamp_threads(int threads, size_t n, size_t min_per_thread) {
  if (threads < 1) threads = 1;
  size_t max_useful = n / min_per_thread;
  if (max_useful < 1) max_useful = 1;
  if ((size_t)threads > max_useful) threads = (int)max_useful;
  unsigned hw = std::thread::hardware_concurrency();
  if (hw > 0 && threads > (int)hw * 2) threads = (int)hw * 2;
  return threads;
}

void parallel_for(int threads, size_t n, void (*fn)(size_t, size_t, void*),
                  void* ctx) {
  if (threads <= 1) {
    fn(0, n, ctx);
    return;
  }
  std::vector<std::thread> pool;
  size_t per = (n + threads - 1) / threads;
  for (int t = 0; t < threads; ++t) {
    size_t lo = (size_t)t * per;
    size_t hi = lo + per < n ? lo + per : n;
    if (lo >= hi) break;
    pool.emplace_back(fn, lo, hi, ctx);
  }
  for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

// Basic mode: byte -> u16 big-endian widen (dst has 2n bytes).
// Reference semantics: tokenizer.rs:116-122.
void blt_widen_be(const uint8_t* src, uint8_t* dst, size_t n, int threads) {
  struct Ctx {
    const uint8_t* src;
    uint8_t* dst;
  } ctx{src, dst};
  threads = clamp_threads(threads, n, 1 << 20);
  parallel_for(
      threads, n,
      [](size_t lo, size_t hi, void* p) {
        auto* c = (Ctx*)p;
        const uint8_t* s = c->src;
        uint8_t* d = c->dst;
        size_t i = lo;
        // Widen 8 bytes at a time: interleave zeros via 64-bit ops.
        for (; i + 8 <= hi; i += 8) {
          uint64_t v;
          memcpy(&v, s + i, 8);
          // little-endian host: byte k of v = s[i+k]; output wants
          // d[2k]=0, d[2k+1]=s[i+k]
          uint64_t lo32 = v & 0xFFFFFFFFull;
          uint64_t hi32 = v >> 32;
          // spread each byte b to 16-bit cell 0xb000.. -> cell value (b<<8)
          auto spread = [](uint64_t x) {
            x = (x | (x << 16)) & 0x0000FFFF0000FFFFull;
            x = (x | (x << 8)) & 0x00FF00FF00FF00FFull;
            return x << 8;  // byte goes to the high half of each LE u16,
                            // which is the SECOND byte in memory (BE wire)
          };
          uint64_t out0 = spread(lo32);
          uint64_t out1 = spread(hi32);
          memcpy(d + 2 * i, &out0, 8);
          memcpy(d + 2 * i + 8, &out1, 8);
        }
        for (; i < hi; ++i) {
          d[2 * i] = 0;
          d[2 * i + 1] = s[i];
        }
      },
      &ctx);
}

// Passthrough: multithreaded memcpy (tokenizer.rs:136-145 semantics).
void blt_copy(const uint8_t* src, uint8_t* dst, size_t n, int threads) {
  struct Ctx {
    const uint8_t* src;
    uint8_t* dst;
  } ctx{src, dst};
  threads = clamp_threads(threads, n, 4 << 20);
  parallel_for(
      threads, n,
      [](size_t lo, size_t hi, void* p) {
        auto* c = (Ctx*)p;
        memcpy(c->dst + lo, c->src + lo, hi - lo);
      },
      &ctx);
}

// Flat BPE over raw bytes: single leftmost-first non-overlapping pass.
// dense: 65536 int32 entries, -1 = no rule (blt_tpu_torch.merges.MergeTable.dense).
// out: u16 BE token stream (capacity 2n bytes). Returns token count.
// carry_in: first byte already consumed by previous chunk's final merge.
// next_byte: first byte of the next chunk (-1 at EOF): a merge may start on
// the final byte, its merged token is emitted here, *carry_out is set.
size_t blt_flat_bpe(const uint8_t* src, size_t n, const int32_t* dense,
                    uint8_t* out, int carry_in, int32_t next_byte,
                    int* carry_out, int threads) {
  // an empty chunk consumes nothing: the pending carry passes through
  *carry_out = carry_in;
  if (n == 0) return 0;
  *carry_out = 0;
  threads = clamp_threads(threads, n, 1 << 20);

  struct Range {
    size_t lo, hi;          // byte range scanned by this thread
    size_t count0, count1;  // emitted tokens under carry 0 / carry 1
    int co0, co1;           // carry-out under carry-in 0 / 1
    size_t prefix_run;      // length of initial match run (carry sensitivity)
  };
  std::vector<Range> ranges(threads);
  size_t per = (n + threads - 1) / threads;

  // Each thread writes its tokens into a private slice of a scratch buffer
  // (worst case 1 token per byte, 2 bytes each), then the main thread
  // stitches with the resolved carries. To avoid a second scan, each thread
  // produces BOTH variants only for its initial match run (the only
  // carry-dependent region); everything after the first non-match is shared.
  std::vector<uint16_t> scratch(n);
  // per-thread: variant-0 token stream in scratch[lo..]; we patch the head
  // when carry=1 (the head differs only in the first run's alternation).

  struct Ctx {
    const uint8_t* src;
    const int32_t* dense;
    size_t n;
    int32_t next_byte;
    Range* ranges;
    uint16_t* scratch;
    size_t per;
    int threads;
  } ctx{src, dense, n, next_byte, ranges.data(), scratch.data(), per, threads};

  auto worker = [](size_t t_lo, size_t t_hi, void* p) {
    auto* c = (Ctx*)p;
    int t = (int)(t_lo / c->per);
    Range& r = c->ranges[t];
    r.lo = t_lo;
    r.hi = t_hi;
    const uint8_t* s = c->src;
    const int32_t* dense = c->dense;
    size_t n = c->n;

    auto pair_val = [&](size_t i) -> int32_t {
      // pair (s[i], s[i+1]) with the one-byte halo at the global end
      if (i + 1 < n) return dense[(uint32_t)s[i] * 256 + s[i + 1]];
      if (c->next_byte >= 0)
        return dense[(uint32_t)s[i] * 256 + (uint32_t)c->next_byte];
      return -1;
    };

    // measure the initial run of matches (carry-sensitive prefix)
    size_t run = 0;
    while (t_lo + run < t_hi && pair_val(t_lo + run) >= 0) ++run;
    r.prefix_run = run;

    // scan assuming carry_in = 0, write variant-0 stream
    uint16_t* out = c->scratch + t_lo;
    size_t cnt = 0;
    size_t i = t_lo;
    bool last_was_merge = false;
    while (i < t_hi) {
      int32_t v = pair_val(i);
      if (v >= 0) {
        out[cnt++] = (uint16_t)v;
        i += 2;
        last_was_merge = true;
      } else {
        out[cnt++] = (uint16_t)s[i];
        i += 1;
        last_was_merge = false;
      }
    }
    // If the final merge consumed the byte at t_hi (or the global halo),
    // carry flows out of this range.
    r.count0 = cnt;
    r.co0 = (last_was_merge && i == t_hi + 1) ? 1 : 0;
    // Under carry_in=1 position t_lo is consumed and the scan starts at
    // t_lo+1, shifting the alternation of the initial match run. A second
    // counting-only scan keeps this exact; it doubles the scan cost for
    // this range but stays fully parallel across threads. (If the range
    // begins with a non-match, both variants agree after the first token,
    // so the rescan is skipped.)
    if (run == 0 && t_hi > t_lo) {
      // byte t_lo is emitted alone in variant 0; variant 1 just drops it
      r.count1 = r.count0 - 1;
      r.co1 = r.co0;
    } else {
      size_t j = t_lo + 1;
      size_t cnt1 = 0;
      bool lwm = false;
      while (j < t_hi) {
        int32_t v = pair_val(j);
        ++cnt1;
        if (v >= 0) {
          j += 2;
          lwm = true;
        } else {
          j += 1;
          lwm = false;
        }
      }
      r.count1 = cnt1;
      r.co1 = (lwm && j == t_hi + 1) ? 1 : 0;
    }
  };
  parallel_for(threads, n, worker, &ctx);

  // Resolve carries sequentially (tiny), then emit.
  // Note ranges[t] for t >= number of spawned threads may be empty.
  int active = 0;
  for (int t = 0; t < threads; ++t)
    if (ranges[t].hi > ranges[t].lo) active = t + 1;

  int carry = carry_in;
  std::vector<int> carries(active);
  for (int t = 0; t < active; ++t) {
    carries[t] = carry;
    carry = carry ? ranges[t].co1 : ranges[t].co0;
  }
  *carry_out = carry;

  // Emit: each range's stream, with the carry-1 head re-scanned on the fly.
  uint8_t* w = out;
  for (int t = 0; t < active; ++t) {
    const Range& r = ranges[t];
    const uint16_t* v0 = scratch.data() + r.lo;
    if (!carries[t]) {
      for (size_t k = 0; k < r.count0; ++k) {
        uint16_t tok = v0[k];
        *w++ = (uint8_t)(tok >> 8);
        *w++ = (uint8_t)(tok & 0xFF);
      }
    } else {
      // re-scan this range with carry=1 (prefix differs; emit directly)
      const uint8_t* s = src;
      size_t i = r.lo + 1;
      while (i < r.hi) {
        int32_t v;
        if (i + 1 < n)
          v = dense[(uint32_t)s[i] * 256 + s[i + 1]];
        else if (next_byte >= 0)
          v = dense[(uint32_t)s[i] * 256 + (uint32_t)next_byte];
        else
          v = -1;
        uint16_t tok = v >= 0 ? (uint16_t)v : (uint16_t)s[i];
        i += v >= 0 ? 2 : 1;
        *w++ = (uint8_t)(tok >> 8);
        *w++ = (uint8_t)(tok & 0xFF);
      }
    }
  }
  return (size_t)(w - out) / 2;
}

// Detokenize a u16-BE wire stream through per-id byte expansions
// (tables built by blt_tpu_torch/ops/decode.py: offsets/lengths int32[65536],
// blob uint8). Two phases so the caller can allocate exactly:
//
//   blt_decode_size: sum of expansion lengths over the wire, or
//                    -(token_index+1) at the first invalid id (length 0).
//   blt_decode_fill: writes every token's expansion at its prefix offset.
//
// Both phases parallelize over token ranges; fill re-derives the range
// start offsets with a cheap lengths-only pass (same deterministic
// range split), so no state is carried between the two calls.
int64_t blt_decode_size(const uint8_t* wire, size_t n_tokens,
                        const int32_t* lengths, int threads) {
  struct Ctx {
    const uint8_t* wire;
    const int32_t* lengths;
    int64_t* sums;
    int64_t* bad;  // first invalid token index per range, -1 if none
    size_t per;
  };
  threads = clamp_threads(threads, n_tokens, 1 << 19);
  std::vector<int64_t> sums(threads, 0);
  std::vector<int64_t> bad(threads, -1);
  size_t per = (n_tokens + threads - 1) / threads;
  Ctx ctx{wire, lengths, sums.data(), bad.data(), per};
  parallel_for(
      threads, n_tokens,
      [](size_t lo, size_t hi, void* p) {
        auto* c = (Ctx*)p;
        int t = (int)(lo / c->per);
        int64_t sum = 0;
        for (size_t i = lo; i < hi; ++i) {
          uint32_t tok = ((uint32_t)c->wire[2 * i] << 8) | c->wire[2 * i + 1];
          int32_t len = c->lengths[tok];
          if (len == 0) {
            if (c->bad[t] < 0) c->bad[t] = (int64_t)i;
            return;
          }
          sum += len;
        }
        c->sums[t] = sum;
      },
      &ctx);
  int64_t total = 0;
  for (int t = 0; t < threads; ++t) {
    if (bad[t] >= 0) return -(bad[t] + 1);
    total += sums[t];
  }
  return total;
}

void blt_decode_fill(const uint8_t* wire, size_t n_tokens,
                     const int32_t* offsets, const int32_t* lengths,
                     const uint8_t* blob, uint8_t* out, int threads) {
  struct Ctx {
    const uint8_t* wire;
    const int32_t* offsets;
    const int32_t* lengths;
    const uint8_t* blob;
    uint8_t* out;
    int64_t* starts;
    size_t per;
  };
  threads = clamp_threads(threads, n_tokens, 1 << 19);
  std::vector<int64_t> starts(threads, 0);
  size_t per = (n_tokens + threads - 1) / threads;
  Ctx ctx{wire, offsets, lengths, blob, out, starts.data(), per};
  // pass 1: per-range output sizes
  parallel_for(
      threads, n_tokens,
      [](size_t lo, size_t hi, void* p) {
        auto* c = (Ctx*)p;
        int t = (int)(lo / c->per);
        int64_t sum = 0;
        for (size_t i = lo; i < hi; ++i) {
          uint32_t tok = ((uint32_t)c->wire[2 * i] << 8) | c->wire[2 * i + 1];
          sum += c->lengths[tok];
        }
        c->starts[t] = sum;
      },
      &ctx);
  int64_t acc = 0;
  for (int t = 0; t < threads; ++t) {
    int64_t s = starts[t];
    starts[t] = acc;
    acc += s;
  }
  // pass 2: expand at prefix offsets
  parallel_for(
      threads, n_tokens,
      [](size_t lo, size_t hi, void* p) {
        auto* c = (Ctx*)p;
        int t = (int)(lo / c->per);
        uint8_t* w = c->out + c->starts[t];
        for (size_t i = lo; i < hi; ++i) {
          uint32_t tok = ((uint32_t)c->wire[2 * i] << 8) | c->wire[2 * i + 1];
          int32_t len = c->lengths[tok];
          if (len == 1) {
            *w++ = (uint8_t)tok;  // ids < 256 expand to themselves
          } else {
            memcpy(w, c->blob + c->offsets[tok], (size_t)len);
            w += len;
          }
        }
      },
      &ctx);
}

// Expand the device-packed flat-BPE stream (ops/bpe_pallas.py
// pack_slots_device) back to the u16-BE wire: packed[i] holds position
// i's emitted byte; flag bit i (LSB-first, 8 positions per flags byte)
// distinguishes a merged-token half (emit the byte alone) from a raw
// byte (emit 0x00 then the byte). Carry-free across batches by
// construction. ``start`` is the first position to expand (the
// halo-sharded drain expands only a slab's payload range [start,
// start+n)). Returns the output byte count (= 2n - popcount(flags)).
size_t blt_unpack_slots(const uint8_t* packed, const uint8_t* flags,
                        size_t start, size_t n, uint8_t* out, int threads) {
  if (n == 0) return 0;
  struct Ctx {
    const uint8_t* packed;
    const uint8_t* flags;
    uint8_t** starts;  // per-range output write pointers (prefix-resolved)
    size_t per;
    size_t start;
  };
  threads = clamp_threads(threads, n, 1 << 20);
  // ranges sized in multiples of 8 positions; the global start offset may
  // still be unaligned, so both passes handle ragged heads/tails. The
  // split is computed ONCE here and dispatched explicitly — parallel_for
  // derives its own (unaligned) split from n, which would disagree with
  // this 8-aligned one and race ranges onto the same output pointer.
  size_t per = (((n + threads - 1) / threads) + 7) & ~(size_t)7;
  int active = (int)((n + per - 1) / per);
  auto dispatch_ranges = [&](void (*fn)(size_t, size_t, void*), void* ctx) {
    if (active <= 1) {
      fn(0, n, ctx);
      return;
    }
    std::vector<std::thread> pool;
    for (int t = 0; t < active; ++t) {
      size_t lo = (size_t)t * per;
      size_t hi = lo + per < n ? lo + per : n;
      pool.emplace_back(fn, lo, hi, ctx);
    }
    for (auto& th : pool) th.join();
  };
  std::vector<size_t> counts(active, 0);
  // pass 1: flagged-bit count per range (output size = 2*len - flagged)
  struct CountCtx {
    const uint8_t* flags;
    size_t* counts;
    size_t per;
    size_t start;
  } cctx{flags, counts.data(), per, start};
  dispatch_ranges(
      [](size_t lo, size_t hi, void* p) {
        auto* c = (CountCtx*)p;
        int t = (int)(lo / c->per);
        size_t cnt = 0;
        size_t i = c->start + lo, end = c->start + hi;
        for (; i < end && (i & 7); ++i)
          cnt += (c->flags[i >> 3] >> (i & 7)) & 1;
        for (; i + 8 <= end; i += 8)
          cnt += (size_t)__builtin_popcount(c->flags[i >> 3]);
        for (; i < end; ++i) cnt += (c->flags[i >> 3] >> (i & 7)) & 1;
        c->counts[t] = cnt;
      },
      &cctx);
  std::vector<uint8_t*> starts(active);
  uint8_t* w0 = out;
  for (int t = 0; t < active; ++t) {
    size_t lo = (size_t)t * per;
    size_t hi = lo + per < n ? lo + per : n;
    starts[t] = w0;
    w0 += 2 * (hi - lo) - counts[t];
  }
  Ctx ctx{packed, flags, starts.data(), per, start};
  // pass 2: expand each range at its resolved offset
  dispatch_ranges(
      [](size_t lo, size_t hi, void* p) {
        auto* c = (Ctx*)p;
        int t = (int)(lo / c->per);
        uint8_t* w = c->starts[t];
        const uint8_t* s = c->packed;
        size_t i = c->start + lo, end = c->start + hi;
        for (; i < end && (i & 7); ++i) {
          uint8_t f = (c->flags[i >> 3] >> (i & 7)) & 1;
          *w = 0;
          w += (f ^ 1);
          *w++ = s[i];
        }
        for (; i + 8 <= end; i += 8) {
          uint8_t fb = c->flags[i >> 3];
          if (fb == 0) {
            // 8 raw bytes -> 16 output bytes: interleave zeros (cf.
            // blt_widen_be)
            uint64_t v;
            memcpy(&v, s + i, 8);
            auto spread = [](uint64_t x) {
              x = (x | (x << 16)) & 0x0000FFFF0000FFFFull;
              x = (x | (x << 8)) & 0x00FF00FF00FF00FFull;
              return x << 8;
            };
            uint64_t out0 = spread(v & 0xFFFFFFFFull);
            uint64_t out1 = spread(v >> 32);
            memcpy(w, &out0, 8);
            memcpy(w + 8, &out1, 8);
            w += 16;
          } else {
            for (int k = 0; k < 8; ++k) {
              uint8_t f = (fb >> k) & 1;
              *w = 0;
              w += (f ^ 1);
              *w++ = s[i + k];
            }
          }
        }
        for (; i < end; ++i) {
          uint8_t f = (c->flags[i >> 3] >> (i & 7)) & 1;
          *w = 0;
          w += (f ^ 1);
          *w++ = s[i];
        }
      },
      &ctx);
  size_t lastlo = (size_t)(active - 1) * per;
  uint8_t* end = starts[active - 1] + 2 * (n - lastlo) - counts[active - 1];
  return (size_t)(end - out);
}

int blt_native_version() { return 3; }

}  // extern "C"

extern "C" {

// Drop-after-merge drain for the Pallas kernel's byteswapped-u16 slots
// (see blt_tpu/ops/bpe_pallas.py): slot i is dropped when slot i-1 has a
// nonzero low byte (i.e. original token >= 256). prev threads the rule
// across batches. Output is the kept u16s verbatim (their LE memory image
// is the u16-BE wire stream). Returns kept count; *last_out = final slot.
size_t blt_filter_slots(const uint16_t* slots, size_t n, uint16_t prev,
                        uint16_t* out, uint16_t* last_out, int threads) {
  // The dependency is only on the PREVIOUS slot, so ranges parallelize
  // with a one-element halo; counts resolve with a serial prefix pass.
  struct Ctx {
    const uint16_t* slots;
    uint16_t* scratch;
    size_t* counts;
    size_t per;
    size_t n;
    uint16_t prev;
  };
  threads = clamp_threads(threads, n, 1 << 20);
  if (n == 0) {
    *last_out = prev;
    return 0;
  }
  std::vector<uint16_t> scratch(n);
  std::vector<size_t> counts(threads, 0);
  size_t per = (n + threads - 1) / threads;
  Ctx ctx{slots, scratch.data(), counts.data(), per, n, prev};
  parallel_for(
      threads, n,
      [](size_t lo, size_t hi, void* p) {
        auto* c = (Ctx*)p;
        int t = (int)(lo / c->per);
        uint16_t* w = c->scratch + lo;
        size_t cnt = 0;
        uint16_t pv = lo == 0 ? c->prev : c->slots[lo - 1];
        for (size_t i = lo; i < hi; ++i) {
          uint16_t s = c->slots[i];
          if ((pv & 0xFF) == 0) w[cnt++] = s;
          pv = s;
        }
        c->counts[t] = cnt;
      },
      &ctx);
  uint16_t* w = out;
  for (int t = 0; t < threads; ++t) {
    size_t lo = (size_t)t * per;
    if (lo >= n) break;
    memcpy(w, scratch.data() + lo, counts[t] * sizeof(uint16_t));
    w += counts[t];
  }
  *last_out = slots[n - 1];
  return (size_t)(w - out);
}

}  // extern "C"
