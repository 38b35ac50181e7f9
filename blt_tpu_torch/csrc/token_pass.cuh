// One general-table merge round over int32 tokens, templated on what the
// round computes: K4 and the four variants of its ablation T4 that are
// rounds are flag sets of it, launched through one entry, blt_token_pass
// (token_pass.cu). T4's copy is token_parts.cu.
//
// Per position i of a buffer of cap tokens with n valid (the function of the
// Pallas _token_pass_kernel when kLookup, kScan and kShift, with the carry 0
// at the start of the call: general tables have per-chunk semantics):
//   nxt   = kShift ? tok[i+1] : tok[i]       (tok[cap] reads as 0)
//   kLookup:  val = cuckoo32 lookup of (tok[i], nxt) (cuckoo32.cuh),
//             m = val found && i < n-1
//   !kLookup: val = tok[i] + 1 (int32 wrap), m = ((tok[i] ^ nxt) & 7) == 3
//             && i < n-1 (tools/exp_mp_ablate.py's stand-in for the lookup)
//   kScan:    lz = max(-1, last j <= i with !m[j]),
//             start = m && ((i - lz) & 1) (leftmost-first, non-overlapping)
//   !kScan:   start = m
//   consumed = start[i-1] (false at i == 0)
//   out   = consumed ? -1 : (start ? val : tok[i])
// The Pallas input's 8 halo rows are a BlockSpec artefact and are dropped:
// the buffer is cap tokens, and position cap-1 can never start a merge
// (n <= cap), so the value read past the end changes no output.
//
// Design: the Pallas grid carries the parity from block to block in SMEM
// because a TPU grid runs in order. CUDA blocks run in no order, so the
// prefix maximum crosses tiles in one of two ways (max_lookback.cuh):
//   - three launches on one stream, with no host sync, as in flat_pass.cuh:
//     tile_reduce (each 4096-position tile's last non-match), tile_scan (one
//     block's exclusive max-scan over the tiles, seeded with -1) and
//     tile_emit (recompute the pairs, scan inside the tile with warp
//     shuffles, write with 16-byte stores). Without the scan a round is
//     tile_emit alone. T4's variants and the parent design of K4 run so.
//   - kLookback (K4 on the main path): one launch, tile_lookback, after one
//     cudaMemsetAsync of the tiles' status words and the ticket. A CTA takes
//     its tile from the ticket, looks each pair up once, publishes its
//     inclusive prefix at once where the tile holds a non-match (else an
//     aggregate), thread 0 walks back to a prefix, and the CTA emits from
//     the registers it holds. The three-launch round looks every pair up
//     twice (reduce and emit); the lookups, not the bytes, bound it.
// Each thread owns 16 consecutive tokens, loaded as four int4.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>
#include <utility>

#include "cuckoo32.cuh"
#include "max_lookback.cuh"

namespace {

// CTAs resident per SM for the look-back round: the lookups' latency is
// hidden by warps, so its registers are held to 40 a thread, as K3's (4 and
// 8 ran slower, 8 spilled: PERF.md)
constexpr int kLookbackBlocksPerSm = 6;

struct Pass {
  const int* tok;
  int cap;  // positions in the buffer (a multiple of 16)
  int n;    // valid positions
  Planes t;
};

// Does a merge start at position i (token d, next token nx)? Sets val to
// the value a start there emits.
template <bool kLookup, bool kShift>
__device__ __forceinline__ bool pair_at(const Pass& b, int i, int d, int nx,
                                        int& val) {
  if (!kShift) nx = d;
  if (i >= b.n - 1) return false;
  if (kLookup) {
    val = cuckoo32_lookup(b.t, d, nx);
    return val >= 0;
  }
  val = (int)((uint32_t)d + 1u);
  return ((d ^ nx) & 7) == 3;
}

// Loads the 16 tokens at i0 and evaluates their pairs: bit k of the result
// is m[i0 + k]. False past cap.
template <bool kLookup, bool kShift>
__device__ __forceinline__ bool load_pairs(const Pass& b, int i0, int d[kPer],
                                           int val[kPer], uint32_t& match) {
  match = 0;
  if (i0 >= b.cap) return false;
  const int4* src = reinterpret_cast<const int4*>(b.tok + i0);
#pragma unroll
  for (int q = 0; q < kPer / 4; ++q) {
    int4 x = src[q];
    d[4 * q] = x.x;
    d[4 * q + 1] = x.y;
    d[4 * q + 2] = x.z;
    d[4 * q + 3] = x.w;
  }
  int after = kShift && i0 + kPer < b.cap ? b.tok[i0 + kPer] : 0;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    bool m = pair_at<kLookup, kShift>(b, i0 + k, d[k],
                                      k + 1 < kPer ? d[k + 1] : after, val[k]);
    match |= (uint32_t)m << k;
  }
  return true;
}

template <bool kLookup, bool kShift>
__global__ void __launch_bounds__(kThreads)
    tile_reduce(Pass b, int* __restrict__ tile_lnm) {
  __shared__ int warp_max[kThreads / 32];
  int i0 = blockIdx.x * kTile + threadIdx.x * kPer;
  int d[kPer], val[kPer];
  uint32_t match;
  int mx = load_pairs<kLookup, kShift>(b, i0, d, val, match)
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
              int nt) {
  __shared__ int warp_tot[kScanThreads / 32];
  int per = (nt + kScanThreads - 1) / kScanThreads;
  int lo = threadIdx.x * per;
  int hi = min(nt, lo + per);
  int local = kNeg;
  for (int j = lo; j < hi; ++j) local = max(local, tile_lnm[j]);
  // the sentinel -1: no merge started before the buffer (carry 0)
  int run = max(block_excl_max<kScanThreads>(local, warp_tot), -1);
  for (int j = lo; j < hi; ++j) {
    tile_excl[j] = run;
    run = max(run, tile_lnm[j]);
  }
}

template <bool kLookup, bool kScan, bool kShift>
__global__ void __launch_bounds__(kThreads)
    tile_emit(Pass b, const int* __restrict__ tile_excl, int* __restrict__ out) {
  __shared__ int warp_tot[kThreads / 32];
  __shared__ unsigned char last_start[kThreads];
  int t = threadIdx.x;
  int tile0 = blockIdx.x * kTile;
  int i0 = tile0 + t * kPer;
  int d[kPer], val[kPer];
  uint32_t match;
  bool live = load_pairs<kLookup, kShift>(b, i0, d, val, match);
  uint32_t starts = match;
  int tile_prefix = -1;
  if (kScan) {
    tile_prefix = tile_excl[blockIdx.x];  // holds the sentinel too
    int mx = live ? last_nonmatch(i0, match) : kNeg;
    starts = scan_starts(i0, match,
                         max(tile_prefix, block_excl_max<kThreads>(mx, warp_tot)));
  }
  last_start[t] = (starts >> (kPer - 1)) & 1u;
  __syncthreads();
  if (!live) return;

  // was position i0 - 1 a merge start?
  uint32_t prev_start;
  if (t > 0) {
    prev_start = last_start[t - 1];
  } else if (blockIdx.x == 0) {
    prev_start = 0;
  } else {
    // the previous tile's last position; under the scan its lz is this
    // tile's prefix
    int ip = tile0 - 1;
    int v;
    bool m = pair_at<kLookup, kShift>(b, ip, b.tok[ip], b.tok[tile0], v);
    prev_start = m && (!kScan || ((ip - tile_prefix) & 1));
  }
  uint32_t consumed = (starts << 1) | prev_start;

  int o[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    o[k] = ((consumed >> k) & 1u) ? -1 : ((starts >> k) & 1u) ? val[k] : d[k];
  }
  int4* dst = reinterpret_cast<int4*>(out + i0);
#pragma unroll
  for (int q = 0; q < kPer / 4; ++q) {
    dst[q] = make_int4(o[4 * q], o[4 * q + 1], o[4 * q + 2], o[4 * q + 3]);
  }
}

// K4 as one launch (kLookup, kScan and kShift): see the design note above.
// Each thread keeps, per position, the one value it writes unless a merge
// consumes it: the pair's value where the pair matches, else the token. A
// match that does not start is always consumed (it follows a start in its
// run of matches), so out = consumed ? -1 : that value.
__global__ void __launch_bounds__(kThreads, kLookbackBlocksPerSm)
    tile_lookback(Pass b, int* __restrict__ out,
                  unsigned long long* __restrict__ status,
                  int* __restrict__ ticket) {
  __shared__ int warp_tot[kThreads / 32];
  __shared__ unsigned char last_start[kThreads];
  __shared__ int s_tile, s_prefix, s_prev_start;
  const int t = threadIdx.x;
  if (t == 0) s_tile = atomicAdd(ticket, 1);
  __syncthreads();
  const int tile = s_tile;
  const int tile0 = tile * kTile;
  const int i0 = tile0 + t * kPer;
  const bool live = i0 < b.cap;
  int w[kPer];
  uint32_t match = 0;
  if (live) {
    const int4* src = reinterpret_cast<const int4*>(b.tok + i0);
#pragma unroll
    for (int q = 0; q < kPer / 4; ++q) {
      int4 x = src[q];
      w[4 * q] = x.x;
      w[4 * q + 1] = x.y;
      w[4 * q + 2] = x.z;
      w[4 * q + 3] = x.w;
    }
    const int after = i0 + kPer < b.cap ? b.tok[i0 + kPer] : 0;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      // the pair (w[k], w[k+1]) while w[k+1] still holds the token
      int v;
      const bool m = pair_at<true, true>(b, i0 + k, w[k],
                                         k + 1 < kPer ? w[k + 1] : after, v);
      if (m) w[k] = v;
      match |= (uint32_t)m << k;
    }
  }
  const int excl = block_excl_max<kThreads>(live ? last_nonmatch(i0, match) : kNeg, warp_tot);
  if (t == 0) {
    // the pair at i0 - 1 (the boundary rule of tile_emit): whether it
    // matches does not depend on the prefix, so look it up before the walk
    const int ip = tile0 - 1;
    int v;
    const bool m = tile > 0 && pair_at<true, true>(b, ip, b.tok[ip], b.tok[tile0], v);
    const int prefix = look_back(status, tile, tile_max(warp_tot), -1);
    s_prefix = prefix;
    s_prev_start = m && ((ip - prefix) & 1);
  }
  __syncthreads();
  const uint32_t starts = scan_starts(i0, match, max(s_prefix, excl));
  last_start[t] = (starts >> (kPer - 1)) & 1u;
  __syncthreads();
  if (!live) return;
  const uint32_t consumed = (starts << 1) | (t > 0 ? last_start[t - 1] : s_prev_start);
  int4* dst = reinterpret_cast<int4*>(out + i0);
#pragma unroll
  for (int q = 0; q < kPer / 4; ++q) {
    int o[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      o[j] = ((consumed >> (4 * q + j)) & 1u) ? -1 : w[4 * q + j];
    }
    dst[q] = make_int4(o[0], o[1], o[2], o[3]);
  }
}

// The round's launches on one stream. scratch: 2 * ceil(cap / 4096) + 1
// int32, 8-byte aligned: the scan's tile words (unused without the scan),
// or the look-back's status words (uint64) and its ticket. Returns the
// first nonzero CUDA error of the launches and the calls before them.
template <bool kLookup, bool kScan, bool kShift, bool kLookback>
int launch_token_pass(const Pass& b, int* out, int* scratch, cudaStream_t s) {
  static_assert(!kLookback || (kLookup && kScan && kShift),
                "the look-back round is K4's");
  int nt = (b.cap + kTile - 1) / kTile;
  if constexpr (kLookback) {
    int err = (int)cudaMemsetAsync(scratch, 0, (2 * nt + 1) * sizeof(int), s);
    if (err) return err;
    tile_lookback<<<nt, kThreads, 0, s>>>(
        b, out, reinterpret_cast<unsigned long long*>(scratch), scratch + 2 * nt);
    return (int)cudaGetLastError();
  }
  int* tile_lnm = scratch;
  int* tile_excl = kScan ? scratch + nt : nullptr;
  if (kScan) {
    tile_reduce<kLookup, kShift><<<nt, kThreads, 0, s>>>(b, tile_lnm);
    int err = (int)cudaGetLastError();
    if (err) return err;
    tile_scan<<<1, kScanThreads, 0, s>>>(tile_lnm, tile_excl, nt);
    err = (int)cudaGetLastError();
    if (err) return err;
  }
  tile_emit<kLookup, kScan, kShift><<<nt, kThreads, 0, s>>>(b, tile_excl, out);
  return (int)cudaGetLastError();
}

// The switches as the bits of one int, in blt_token_pass's order.
enum TokenFlag : int {
  kFlagLookup = 1,
  kFlagScan = 2,
  kFlagShift = 4,
  kFlagLookback = 8,
};

template <int F>
int token_pass_of(const Pass& b, int* out, int* scratch, cudaStream_t s) {
  return launch_token_pass<(F & kFlagLookup) != 0, (F & kFlagScan) != 0,
                           (F & kFlagShift) != 0, (F & kFlagLookback) != 0>(
      b, out, scratch, s);
}

// The round of flag set `flags` among the sets F...: only those are
// instantiated; any other set is cudaErrorInvalidValue.
template <int... F>
int dispatch_token_pass(int flags, std::integer_sequence<int, F...>,
                        const Pass& b, int* out, int* scratch, cudaStream_t s) {
  int err = (int)cudaErrorInvalidValue;
  (void)((flags == F && ((err = token_pass_of<F>(b, out, scratch, s)), true)) || ...);
  return err;
}

}  // namespace
