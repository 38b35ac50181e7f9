// The tile layout and the leftmost-first parity scan that the flat pass
// (flat_pass.cuh: K2 and its variants) and the merge round over compacted
// tokens (token_pass.cuh: K4 and its variants) share: each thread owns 16
// consecutive positions of a 4096-position tile, a merge starts where the
// run of matches it ends began an odd number of positions back, and that
// run's origin is a prefix maximum of the non-match indices, carried from
// tile to tile by a reduce / tile scan / emit sequence or by the decoupled
// look-back below.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 16;                // positions per thread
constexpr int kTile = kThreads * kPer;  // positions per block
constexpr int kScanThreads = 1024;
constexpr int kNeg = -2147483647;       // -(2^31) + 1, the Pallas _NEG

// Last non-match position among the 16 at i0 (kNeg if all match).
__device__ __forceinline__ int last_nonmatch(int i0, uint32_t match) {
  uint32_t non = ~match & 0xFFFFu;
  return non ? i0 + 31 - __clz(non) : kNeg;
}

// Exclusive max-scan across the threads of a block of N threads. After it,
// warp_tot holds each warp's inclusive maximum.
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

// The start bits of the 16 positions at i0 under the scan, run being the
// last non-match before i0 (the sentinel included).
__device__ __forceinline__ uint32_t scan_starts(int i0, uint32_t match, int run) {
  uint32_t starts = 0;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    int i = i0 + k;
    if (!((match >> k) & 1u)) {
      run = i;
    } else if ((i - run) & 1) {
      starts |= 1u << k;
    }
  }
  return starts;
}

// A tile's status word for the look-back: the state in the high 32 bits
// (0 not yet, kAggregate: all match, prefix not known; kPrefix: the
// inclusive prefix), the value in the low 32.
constexpr unsigned long long kAggregate = 1ull << 32;
constexpr unsigned long long kPrefix = 2ull << 32;

__device__ __forceinline__ void publish(unsigned long long* status, int tile,
                                        unsigned long long state, int value) {
  atomicExch(status + tile, state | (uint32_t)value);
}

// The exclusive prefix of `tile` (thread 0 only), whose own maximum is agg:
// publishes the tile's status (its inclusive prefix at once when it holds a
// non-match, since a later index is larger than any earlier one; else an
// aggregate), then reads its predecessors' words, nearest first, until one
// holds a prefix (or past tile 0: the sentinel), and publishes its own
// prefix where it had not. Tiles are taken from a ticket in order, so every
// word waited on belongs to a block that has started.
__device__ int look_back(unsigned long long* status, int tile, int agg,
                         int sentinel) {
  if (agg != kNeg) publish(status, tile, kPrefix, agg);
  else if (tile > 0) publish(status, tile, kAggregate, kNeg);
  int excl = sentinel;
  for (int j = tile - 1; j >= 0; --j) {
    unsigned long long w;
    do {
      w = *reinterpret_cast<volatile unsigned long long*>(status + j);
    } while (w == 0);
    if (w >= kPrefix) {
      excl = (int)(uint32_t)w;
      break;
    }
  }
  if (agg == kNeg) publish(status, tile, kPrefix, excl);
  return excl;
}

// The tile's maximum (thread 0, after block_excl_max filled warp_tot).
__device__ __forceinline__ int tile_max(const int* warp_tot) {
  int agg = kNeg;
  for (int w = 0; w < kThreads / 32; ++w) agg = max(agg, warp_tot[w]);
  return agg;
}

}  // namespace
