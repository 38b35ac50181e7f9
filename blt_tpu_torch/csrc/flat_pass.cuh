// One flat-BPE pass as reduce / tile max-scan / emit, or as one launch with a
// decoupled look-back, templated on what the pass computes: K2, its cost
// split T8, four of its ablations T6 and the design probes T2 and T10 are
// flag sets of this one pass, launched through one entry, blt_flat_pass
// (flat_bpe.cu). scan_parts.cu reuses its helpers for the block-local scans,
// and flat_bpe.cu's flat_packed_kernel (K2 fused with its pack, the main
// path's) its pairs and look-back. The tile layout, the parity scan and the
// look-back's protocol are max_lookback.cuh's, shared with token_pass.cuh.
//
// Per position i of a batch with n valid bytes (the function of the Pallas
// _kernel_body when kLookup, kScan, kValid, !kSwap, !kOdd and !kRowWrap):
//   nxt   = data[i+1] (0 past cap), or max(next_byte, 0) at i == n-1
//   valid = i < n-1 || (i == n-1 && next_byte >= 0); !kValid: every i < cap
//   kLookup:  val = table[d*256 + nxt] (pre-byteswapped u16, 0 = no rule),
//             m = valid && val != 0
//   !kLookup: val = d*256 + nxt, m = valid && (nxt & 7) == 0
//             (tools/exp_parts.py's stand-in for the lookup)
//   kScan:    lz = max(-1 - carry_in, last j <= i with !m[j]),
//             start = m && ((i - lz) & 1) (leftmost-first, non-overlapping)
//   !kScan:   start = m, or with kOdd m && (i & 1) (a guessed parity)
//   consumed = start[i-1], or carry_in at i == 0
//   slot  = consumed ? 0 : (start ? (kSwap ? bswap16(val) : val) : d << 8)
//   carry_out = n > 0 ? start[n-1] : carry_in
// kRowWrap keeps both shifts inside each 128-byte row (tools/exp_scan.py's
// noshifts): nxt = the byte at lane (l+1) mod 128 of the same row, with no
// next_byte patch (valid is unchanged), and consumed = start at lane
// (l-1) mod 128 of the same row, with no carry_in; the scan is unchanged.
// kLookback and kSmem change how the pass runs, not what it computes.
//
// Design: the Pallas kernel carries the block-to-block state in SMEM because
// a TPU grid runs in order. CUDA blocks run in no order, so by default the
// prefix maximum is split into three launches on one stream, with no host
// sync:
//   1. tile_reduce: each 4096-position tile records its last non-match
//      index (or kNeg);
//   2. tile_scan: one block takes the exclusive max-scan over the tiles,
//      seeded with the sentinel -1 - carry_in;
//   3. tile_emit: each tile recomputes its pairs, scans within the tile
//      (warp shuffles), writes its slots with 16-byte stores, and the thread
//      that owns n-1 writes carry_out.
// kLookback (T2's p2, the card's counterpart of a relaid cross-block scan)
// is one launch, tile_lookback: a block takes tiles from an atomic ticket,
// so every earlier tile is held by a block that has started; it publishes
// its tile's status word (the inclusive prefix at once when the tile has a
// non-match, since a later index is larger than any earlier one; else an
// "aggregate" of kNeg), walks back over its predecessors' words until it
// finds a prefix, and emits as tile_emit does. Status words and the ticket
// are zeroed on the stream before the launch. kSmem (T2's hoist) stages the
// 128 KB table in shared memory once per block, on a persistent grid of one
// block per SM that takes tiles until none is left.
// Without the scan (kScan false) the pass is tile_emit alone: a start needs
// only its own match bit. The table is the dense 64K-entry wire table
// (ops/tables.py), read through the read-only data cache. Each thread owns
// 16 consecutive positions, loaded as one uint4.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>
#include <utility>

#include "max_lookback.cuh"

namespace {

constexpr int kTableEntries = 65536;

struct Batch {
  const uint8_t* data;
  const uint16_t* table;
  int cap;        // positions in the buffer (a multiple of 16)
  int n;          // valid positions
  int next_byte;  // first byte of the next batch, -1 at end of stream
};

// Does a merge candidate start at position i (byte d, next byte nx)? Sets
// val to the value a start there emits (before any swap). kSmem: b.table
// points into shared memory.
template <bool kLookup, bool kRowWrap = false, bool kValid = true,
          bool kSmem = false>
__device__ __forceinline__ bool pair_at(const Batch& b, int i, int d, int nx,
                                        int& val) {
  if (!kValid) {
    if (i == b.n - 1) nx = max(b.next_byte, 0);
  } else if (i < b.n - 1) {
    // the pair lies inside the batch
  } else if (i == b.n - 1 && b.next_byte >= 0) {
    if (!kRowWrap) nx = b.next_byte;
  } else {
    val = 0;
    return false;
  }
  if (kLookup) {
    int at = (d << 8) | nx;
    val = kSmem ? b.table[at] : __ldg(b.table + at);
    return val != 0;
  }
  val = (d << 8) | nx;
  return (nx & 7) == 0;
}

// The byte after position i0 + 15: the next one, or under kRowWrap the
// first of the row when i0 + 15 ends a row (cap is then a multiple of 128).
template <bool kRowWrap>
__device__ __forceinline__ int byte_after(const Batch& b, int i0) {
  int j = i0 + kPer;
  if (kRowWrap && (j & 127) == 0) j -= 128;
  return j < b.cap ? b.data[j] : 0;
}

// Loads the 16 bytes at i0 and evaluates their 16 pairs: bit k of the
// result is m[i0 + k]. False past cap.
template <bool kLookup, bool kRowWrap = false, bool kValid = true,
          bool kSmem = false>
__device__ __forceinline__ bool load_pairs(const Batch& b, int i0,
                                           int d[kPer], int val[kPer],
                                           uint32_t& match) {
  match = 0;
  if (i0 >= b.cap) return false;
  uint4 x = *reinterpret_cast<const uint4*>(b.data + i0);
  uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int k = 0; k < kPer; ++k) d[k] = (w[k >> 2] >> (8 * (k & 3))) & 0xFF;
  int after = byte_after<kRowWrap>(b, i0);
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    bool m = pair_at<kLookup, kRowWrap, kValid, kSmem>(
        b, i0 + k, d[k], k + 1 < kPer ? d[k + 1] : after, val[k]);
    match |= (uint32_t)m << k;
  }
  return true;
}

template <bool kLookup, bool kRowWrap, bool kValid = true>
__global__ void __launch_bounds__(kThreads)
    tile_reduce(Batch b, int* __restrict__ tile_lnm) {
  __shared__ int warp_max[kThreads / 32];
  int i0 = blockIdx.x * kTile + threadIdx.x * kPer;
  int d[kPer], val[kPer];
  uint32_t match;
  int mx = load_pairs<kLookup, kRowWrap, kValid>(b, i0, d, val, match)
               ? last_nonmatch(i0, match)
               : kNeg;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    mx = max(mx, __shfl_down_sync(0xffffffffu, mx, o));
  }
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = mx;
  __syncthreads();
  if (threadIdx.x == 0) {
    int m = kNeg;
    for (int w = 0; w < kThreads / 32; ++w) m = max(m, warp_max[w]);
    tile_lnm[blockIdx.x] = m;
  }
}

__global__ void __launch_bounds__(kScanThreads)
    tile_scan(const int* __restrict__ tile_lnm, int* __restrict__ tile_excl,
              int nt, const int* __restrict__ carry_in) {
  __shared__ int warp_tot[kScanThreads / 32];
  int per = (nt + kScanThreads - 1) / kScanThreads;
  int lo = threadIdx.x * per;
  int hi = min(nt, lo + per);
  int local = kNeg;
  for (int j = lo; j < hi; ++j) local = max(local, tile_lnm[j]);
  int run = max(block_excl_max<kScanThreads>(local, warp_tot), -1 - carry_in[0]);
  for (int j = lo; j < hi; ++j) {
    tile_excl[j] = run;
    run = max(run, tile_lnm[j]);
  }
}

// Writes one thread's 16 slots of tile `tile` from its start bits, and
// carry_out where it owns n-1. Every thread of the block calls it (it
// synchronises once); tile_prefix is the tile's exclusive prefix under the
// scan, last_start the block's 256 bytes of shared scratch.
template <bool kLookup, bool kScan, bool kSwap, bool kOdd, bool kRowWrap,
          bool kValid, bool kSmem>
__device__ __forceinline__ void emit_slots(
    const Batch& b, int tile, bool live, const int d[kPer],
    const int val[kPer], uint32_t starts, int tile_prefix,
    const int* __restrict__ carry_in, uint16_t* __restrict__ slots,
    int* __restrict__ carry_out, unsigned char* last_start) {
  int t = threadIdx.x;
  int tile0 = tile * kTile;
  int i0 = tile0 + t * kPer;
  last_start[t] = (starts >> (kPer - 1)) & 1u;
  __syncthreads();
  if (!live) return;

  // was position i0 - 1 a merge start? (under kRowWrap: the row's last
  // position where i0 opens a row; a tile holds whole rows)
  uint32_t prev_start;
  if (kRowWrap && (i0 & 127) == 0) {
    prev_start = last_start[t + 128 / kPer - 1];
  } else if (t > 0) {
    prev_start = last_start[t - 1];
  } else if (tile == 0) {
    prev_start = carry_in[0] != 0;
  } else {
    // the previous tile's last position; under the scan its lz is this
    // tile's prefix
    int ip = tile0 - 1;
    int v;
    bool m = pair_at<kLookup, false, kValid, kSmem>(b, ip, b.data[ip],
                                                    b.data[tile0], v);
    prev_start = m && (kScan ? ((ip - tile_prefix) & 1) : (!kOdd || (ip & 1)));
  }
  uint32_t consumed = (starts << 1) | prev_start;

  uint32_t w[kPer / 2];
#pragma unroll
  for (int j = 0; j < kPer / 2; ++j) {
    uint32_t s[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int k = 2 * j + h;
      uint32_t v = (uint32_t)val[k] & 0xFFFFu;
      if (kSwap) v = ((v & 0xFFu) << 8) | (v >> 8);
      s[h] = ((consumed >> k) & 1u) ? 0u
             : ((starts >> k) & 1u) ? v
                                    : (uint32_t)d[k] << 8;
    }
    w[j] = s[0] | (s[1] << 16);
  }
  uint4* out = reinterpret_cast<uint4*>(slots + i0);
  out[0] = make_uint4(w[0], w[1], w[2], w[3]);
  out[1] = make_uint4(w[4], w[5], w[6], w[7]);

  int last = b.n - 1;
  if (last >= i0 && last < i0 + kPer) carry_out[0] = (starts >> (last - i0)) & 1u;
  if (b.n == 0 && i0 == 0) carry_out[0] = carry_in[0];
}

template <bool kLookup, bool kScan, bool kSwap, bool kOdd, bool kRowWrap,
          bool kValid = true>
__global__ void __launch_bounds__(kThreads)
    tile_emit(Batch b, const int* __restrict__ tile_excl,
              const int* __restrict__ carry_in, uint16_t* __restrict__ slots,
              int* __restrict__ carry_out) {
  __shared__ int warp_tot[kThreads / 32];
  __shared__ unsigned char last_start[kThreads];
  int i0 = blockIdx.x * kTile + threadIdx.x * kPer;
  int d[kPer], val[kPer];
  uint32_t match;
  bool live = load_pairs<kLookup, kRowWrap, kValid>(b, i0, d, val, match);
  // i0 is even: the odd positions are the odd bits
  uint32_t starts = kOdd ? match & 0xAAAAu : match;
  int tile_prefix = kNeg;
  if (kScan) {
    tile_prefix = tile_excl[blockIdx.x];  // holds the sentinel too
    int mx = live ? last_nonmatch(i0, match) : kNeg;
    starts = scan_starts(i0, match,
                         max(tile_prefix, block_excl_max<kThreads>(mx, warp_tot)));
  }
  emit_slots<kLookup, kScan, kSwap, kOdd, kRowWrap, kValid, false>(
      b, blockIdx.x, live, d, val, starts, tile_prefix, carry_in, slots,
      carry_out, last_start);
}

template <bool kLookup, bool kSwap, bool kValid, bool kSmem>
__global__ void __launch_bounds__(kThreads)
    tile_lookback(Batch b, int nt, const int* __restrict__ carry_in,
                  uint16_t* __restrict__ slots, int* __restrict__ carry_out,
                  unsigned long long* __restrict__ status,
                  int* __restrict__ ticket) {
  extern __shared__ uint4 staged_table[];  // kSmem: the 128 KB table
  __shared__ int warp_tot[kThreads / 32];
  __shared__ unsigned char last_start[kThreads];
  __shared__ int s_tile, s_prefix;
  if (kSmem) {
    const uint4* src = reinterpret_cast<const uint4*>(b.table);
    for (int k = threadIdx.x; k < kTableEntries / 8; k += kThreads) {
      staged_table[k] = src[k];
    }
    b.table = reinterpret_cast<const uint16_t*>(staged_table);
  }
  for (;;) {
    if (threadIdx.x == 0) s_tile = atomicAdd(ticket, 1);
    __syncthreads();  // also: the staged table, and the last tile's scratch
    int tile = s_tile;
    if (tile >= nt) break;
    int i0 = tile * kTile + threadIdx.x * kPer;
    int d[kPer], val[kPer];
    uint32_t match;
    bool live = load_pairs<kLookup, false, kValid, kSmem>(b, i0, d, val, match);
    int mx = live ? last_nonmatch(i0, match) : kNeg;
    int excl = block_excl_max<kThreads>(mx, warp_tot);
    if (threadIdx.x == 0) {
      s_prefix = look_back(status, tile, tile_max(warp_tot), -1 - carry_in[0]);
    }
    __syncthreads();
    int tile_prefix = s_prefix;
    uint32_t starts = scan_starts(i0, match, max(tile_prefix, excl));
    emit_slots<kLookup, true, kSwap, false, false, kValid, kSmem>(
        b, tile, live, d, val, starts, tile_prefix, carry_in, slots,
        carry_out, last_start);
  }
}

// The pass's launches on one stream. scratch: 2 * ceil(cap / 4096) + 2
// int32, 8-byte aligned (unused without the scan). Returns the first
// nonzero CUDA error of the launches and the calls before them.
template <bool kLookup, bool kScan, bool kSwap, bool kOdd = false,
          bool kRowWrap = false, bool kLookback = false, bool kSmem = false,
          bool kValid = true>
int launch_flat_pass(const Batch& b, const int* carry_in, uint16_t* slots,
                     int* carry_out, int* scratch, cudaStream_t s) {
  static_assert(!(kOdd && kScan), "a guessed parity replaces the scan");
  static_assert(!kLookback || (kScan && !kOdd && !kRowWrap),
                "the look-back is the scan of a linear pass");
  static_assert(!kSmem || (kLookback && kLookup),
                "the staged table is the look-back pass's");
  int nt = (b.cap + kTile - 1) / kTile;
  if constexpr (kLookback) {
    // status words (nt uint64), then the ticket
    int err = (int)cudaMemsetAsync(scratch, 0, (2 * nt + 1) * sizeof(int), s);
    if (err) return err;
    auto kernel = tile_lookback<kLookup, kSwap, kValid, kSmem>;
    int grid = nt;
    size_t smem = 0;
    if (kSmem) {
      int dev, sms;
      err = (int)cudaGetDevice(&dev);
      if (!err) err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      smem = kTableEntries * sizeof(uint16_t);
      if (!err) err = (int)cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err) return err;
      grid = nt < sms ? nt : sms;
    }
    kernel<<<grid, kThreads, smem, s>>>(
        b, nt, carry_in, slots, carry_out,
        reinterpret_cast<unsigned long long*>(scratch), scratch + 2 * nt);
    return (int)cudaGetLastError();
  } else {
    int* tile_lnm = scratch;
    int* tile_excl = kScan ? scratch + nt : nullptr;
    if (kScan) {
      tile_reduce<kLookup, kRowWrap, kValid><<<nt, kThreads, 0, s>>>(b, tile_lnm);
      int err = (int)cudaGetLastError();
      if (err) return err;
      tile_scan<<<1, kScanThreads, 0, s>>>(tile_lnm, tile_excl, nt, carry_in);
      err = (int)cudaGetLastError();
      if (err) return err;
    }
    tile_emit<kLookup, kScan, kSwap, kOdd, kRowWrap, kValid><<<nt, kThreads, 0, s>>>(
        b, tile_excl, carry_in, slots, carry_out);
    return (int)cudaGetLastError();
  }
}

// The switches as the bits of one int, in blt_flat_pass's order.
enum FlatFlag : int {
  kFlagLookup = 1,
  kFlagScan = 2,
  kFlagSwap = 4,
  kFlagOdd = 8,
  kFlagRowWrap = 16,
  kFlagLookback = 32,
  kFlagSmemTable = 64,
  kFlagValid = 128,
};

// launch_flat_pass for flag set F.
template <int F>
int flat_pass_of(const Batch& b, const int* carry_in, uint16_t* slots,
                 int* carry_out, int* scratch, cudaStream_t s) {
  return launch_flat_pass<(F & kFlagLookup) != 0, (F & kFlagScan) != 0,
                          (F & kFlagSwap) != 0, (F & kFlagOdd) != 0,
                          (F & kFlagRowWrap) != 0, (F & kFlagLookback) != 0,
                          (F & kFlagSmemTable) != 0, (F & kFlagValid) != 0>(
      b, carry_in, slots, carry_out, scratch, s);
}

// The pass of flag set `flags` among the sets F...: only those are
// instantiated; any other set is cudaErrorInvalidValue.
template <int... F>
int dispatch_flat_pass(int flags, std::integer_sequence<int, F...>,
                       const Batch& b, const int* carry_in, uint16_t* slots,
                       int* carry_out, int* scratch, cudaStream_t s) {
  int err = (int)cudaErrorInvalidValue;
  (void)((flags == F &&
          ((err = flat_pass_of<F>(b, carry_in, slots, carry_out, scratch, s)), true)) ||
         ...);
  return err;
}

}  // namespace
