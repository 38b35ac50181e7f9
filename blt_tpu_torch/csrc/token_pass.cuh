// One general-table merge round over int32 tokens as reduce / tile max-scan /
// emit, templated on what the round computes: K4 and the four variants of its
// ablation T4 that are rounds are flag sets of it, launched through one
// entry, blt_token_pass (token_pass.cu). T4's copy is token_parts.cu.
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
// prefix maximum is split into three launches on one stream, with no host
// sync, as in flat_pass.cuh: tile_reduce (each 4096-position tile's last
// non-match), tile_scan (one block's exclusive max-scan over the tiles,
// seeded with -1) and tile_emit (recompute the pairs, scan inside the tile
// with warp shuffles, write with 16-byte stores). Without the scan a round
// is tile_emit alone. Each thread owns 16 consecutive tokens, loaded as four
// int4.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>
#include <utility>

#include "cuckoo32.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 16;                // positions per thread
constexpr int kTile = kThreads * kPer;  // positions per block
constexpr int kScanThreads = 1024;
constexpr int kNeg = -2147483647;       // -(2^31) + 1, the Pallas _NEG

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

// Last non-match position among the 16 at i0 (kNeg if all match).
__device__ __forceinline__ int last_nonmatch(int i0, uint32_t match) {
  uint32_t non = ~match & 0xFFFFu;
  return non ? i0 + 31 - __clz(non) : kNeg;
}

// Exclusive max-scan across the threads of a block of N threads.
template <int N>
__device__ __forceinline__ int block_excl_max(int v, int* warp_tot) {
  int lane = threadIdx.x & 31;
  int warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    int y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl = max(incl, y);
  }
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  int prefix = kNeg;
  for (int w = 0; w < warp; ++w) prefix = max(prefix, warp_tot[w]);
  int excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = kNeg;
  return max(prefix, excl);
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
    int run = max(tile_prefix, block_excl_max<kThreads>(mx, warp_tot));
    starts = 0;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      int i = i0 + k;
      if (!((match >> k) & 1u)) {
        run = i;
      } else if ((i - run) & 1) {
        starts |= 1u << k;
      }
    }
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

// The round's launches on one stream. scratch: 2 * ceil(cap / 4096) int32
// (unused without the scan). Returns the first nonzero cudaGetLastError().
template <bool kLookup, bool kScan, bool kShift>
int launch_token_pass(const Pass& b, int* out, int* scratch, cudaStream_t s) {
  int nt = (b.cap + kTile - 1) / kTile;
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
  kFlagSets = 8,
};

using TokenPassFn = int (*)(const Pass&, int*, int*, cudaStream_t);

template <int F>
int token_pass_of(const Pass& b, int* out, int* scratch, cudaStream_t s) {
  return launch_token_pass<(F & kFlagLookup) != 0, (F & kFlagScan) != 0,
                           (F & kFlagShift) != 0>(b, out, scratch, s);
}

template <int... F>
int dispatch_token_pass(int flags, std::integer_sequence<int, F...>,
                        const Pass& b, int* out, int* scratch, cudaStream_t s) {
  static constexpr TokenPassFn passes[] = {&token_pass_of<F>...};
  if (flags < 0 || flags >= kFlagSets) return (int)cudaErrorInvalidValue;
  return passes[flags](b, out, scratch, s);
}

}  // namespace
