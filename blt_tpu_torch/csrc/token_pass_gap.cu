// One general-table merge round over a tombstoned int32 stream (K3).
//
// Replaces: blt_tpu/ops/bpe_pallas.py::_token_pass_gap_call (kernel body
// _token_pass_gap_kernel), the pass that _multipass_gap_resident_call loops
// until a round merges nothing.
//
// Input: cap int32 tokens, -1 marking both tombstones (consumed by an
// earlier round) and padding. Per position i (the function of
// _token_pass_gap_kernel, with the state 0 at the start of the call):
//   alive = tok[i] >= 0
//   nxt   = the first alive value among tok[i+1..i+4], -1 if none
//           (_GAP_LOOKAHEAD = 4; positions past the buffer are -1)
//   val   = cuckoo32 lookup of (tok[i], nxt), -1 = no rule (cuckoo32.cuh)
//   m     = val >= 0 && alive && nxt >= 0
//   code  = alive ? (m ? flip (3) : reset (0)) : identity (2)
//   s_in  = the exclusive composition of the codes before i applied to 0:
//           the merge-start bit of the previous alive position
//   start = m && !s_in,   consumed = alive && s_in
//   out   = (consumed || !alive) ? -1 : (start ? val : tok[i])
//   count = the number of positions with out >= 0, over the whole buffer.
// A code packs the transform x -> a ^ (b & x) as a | b << 1, and
// compose(later, earlier) is the Pallas _compose_affine: associative, with
// identity 2. The Pallas kernel's per-block alive counts depend on its block
// size, so only their sum is part of the function: that is `count`.
//
// The bounded look-ahead is part of the function: a run of four or more
// tombstones breaks a pair here. The loop never builds one (it compacts
// every third round), but the kernel reproduces it exactly.
//
// Bound on the H100: the bytes, 4 in and 4 out per position (64 MiB each way
// at 16 Mi tokens, about 40 us at 3.35 TB/s). Each alive position costs one
// or two dependent gathers into the planes: 128 KB at the default 8192
// slots, which the read-only cache holds; a wide table's 1 MiB at 65,536
// slots (ops/tables.py cuckoo32_placement) is read through L2.
//
// Design: the Pallas grid carries the composition state from block to block
// in SMEM; CUDA blocks run in no order. So, as K2's look-back pass does for
// its max (flat_pass.cuh, tile_lookback), the round is one launch on one
// stream, after one cudaMemsetAsync of its status words, ticket and count:
// a CTA takes its 4096-position tile from an atomic ticket (so tiles start
// in order and every walk back ends), loads its tokens and looks each alive
// position's pair up once (each thread owns 16 consecutive tokens, loaded as
// four int4, plus the next four as a fifth int4), and composes the tile's
// code (order-keeping warp shuffles). A tile with an alive non-matching
// position has a constant code (a reset): it publishes its inclusive prefix,
// the state leaving it, at once; any other publishes its code as an
// aggregate. Thread 0 then walks back over its predecessors' 64-bit status
// words, composing their aggregates until it meets a prefix (or passes tile
// 0, whose entering state is 0), and publishes its own prefix where it had
// not. The CTA emits from the registers it holds (16-byte stores) and adds
// the tile's alive count with one atomic. The lookups, not the bytes, bound
// the round, so no pair is looked up twice.

#include <cstdint>
#include <cuda_runtime.h>

#include "cuckoo32.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 16;                // positions per thread
constexpr int kTile = kThreads * kPer;  // positions per block
constexpr int kLook = 4;                // _GAP_LOOKAHEAD
constexpr int kIdentity = 2;
// CTAs resident per SM: the lookups' latency is hidden by warps, so the
// registers are held to 40 a thread (6, 4 and 1 measured 0.104, 0.110 and
// 0.112 ms a round, 8 spilled: PERF.md)
constexpr int kBlocksPerSm = 6;

__device__ __forceinline__ int compose(int later, int earlier) {
  return ((later ^ ((later >> 1) & earlier)) & 1) | (later & earlier & 2);
}

__device__ __forceinline__ int apply(int f, int x) {
  return (f & 1) ^ ((f >> 1) & x);
}

struct GapPass {
  const int* tok;
  int cap;  // positions in the buffer (a multiple of 16)
  Planes t;
};

// Loads the 16 tokens at i0 (and the 4 after them), looks each alive
// position's pair up once, and keeps what the emit needs: w[k], the value
// position k writes when no merge consumes it (the pair's value where it
// has a rule, else the token), and the codes, two bits per position
// (position k at bits 2k). False past cap.
__device__ __forceinline__ bool load_codes(const GapPass& b, int i0, int w[kPer],
                                           uint32_t& codes) {
  if (i0 >= b.cap) return false;
  int t[kPer + kLook];
  const int4* src = reinterpret_cast<const int4*>(b.tok + i0);
#pragma unroll
  for (int q = 0; q < (kPer + kLook) / 4; ++q) {
    int4 x = (q < kPer / 4 || i0 + kPer < b.cap) ? src[q]
                                                 : make_int4(-1, -1, -1, -1);
    t[4 * q] = x.x;
    t[4 * q + 1] = x.y;
    t[4 * q + 2] = x.z;
    t[4 * q + 3] = x.w;
  }
  codes = 0;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    int nx = t[k + 1];
#pragma unroll
    for (int j = 2; j <= kLook; ++j) {
      if (nx < 0) nx = t[k + j];
    }
    const bool alive = t[k] >= 0;
    const int val = (alive && nx >= 0) ? cuckoo32_lookup(b.t, t[k], nx) : -1;
    const uint32_t code = !alive ? kIdentity : (val >= 0 ? 3 : 0);
    codes |= code << (2 * k);
    w[k] = val >= 0 ? val : t[k];
  }
  return true;
}

// Exclusive composition-scan across the threads of a block of N threads,
// in thread order (the composition is not commutative).
template <int N>
__device__ __forceinline__ int block_excl_compose(int v, int* warp_tot) {
  int lane = threadIdx.x & 31;
  int warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    int y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl = compose(incl, y);
  }
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  int prefix = kIdentity;
  for (int w = 0; w < warp; ++w) prefix = compose(warp_tot[w], prefix);
  int excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = kIdentity;
  return compose(excl, prefix);
}

__device__ __forceinline__ int thread_code(uint32_t codes) {
  int f = kIdentity;
#pragma unroll
  for (int k = 0; k < kPer; ++k) f = compose((codes >> (2 * k)) & 3, f);
  return f;
}

// A tile's status word: the kind in the high 32 bits (0 not yet published,
// kAggregate: the tile's code, kPrefix: the state leaving the tile), the
// value in the low 32.
constexpr unsigned long long kAggregate = 1ull << 32;
constexpr unsigned long long kPrefix = 2ull << 32;

__device__ __forceinline__ void publish(unsigned long long* status, int tile,
                                        unsigned long long kind, int value) {
  atomicExch(status + tile, kind | (uint32_t)value);
}

// The state entering `tile` (thread 0 only), whose code is `agg`: publishes
// the tile's status, then composes its predecessors' aggregates, nearest
// first, until one holds a prefix or the walk passes tile 0 (state 0).
__device__ int look_back(unsigned long long* status, int tile, int agg) {
  const bool reset = !(agg & 2);  // a constant code: the state leaving is known
  if (reset) publish(status, tile, kPrefix, apply(agg, 0));
  else if (tile > 0) publish(status, tile, kAggregate, agg);
  int f = kIdentity;  // the predecessors' codes composed so far
  int state = 0;
  for (int j = tile - 1; j >= 0; --j) {
    unsigned long long w;
    do {
      w = *reinterpret_cast<volatile unsigned long long*>(status + j);
    } while (w == 0);
    if (w >= kPrefix) {
      state = (int)(uint32_t)w;
      break;
    }
    f = compose(f, (int)(uint32_t)w);
  }
  state = apply(f, state);
  if (!reset) publish(status, tile, kPrefix, apply(agg, state));
  return state;
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    tile_lookback(GapPass b, int* __restrict__ out, int* __restrict__ count,
                  unsigned long long* __restrict__ status, int* __restrict__ ticket) {
  __shared__ int warp_tot[kThreads / 32];
  __shared__ int warp_alive[kThreads / 32];
  __shared__ int s_tile, s_state;
  if (threadIdx.x == 0) s_tile = atomicAdd(ticket, 1);
  __syncthreads();
  const int tile = s_tile;
  const int i0 = tile * kTile + threadIdx.x * kPer;
  int w[kPer];
  uint32_t codes;
  const bool live = load_codes(b, i0, w, codes);
  const int f = live ? thread_code(codes) : kIdentity;
  const int excl = block_excl_compose<kThreads>(f, warp_tot);
  if (threadIdx.x == 0) {
    int agg = kIdentity;
    for (int w = 0; w < kThreads / 32; ++w) agg = compose(warp_tot[w], agg);
    s_state = look_back(status, tile, agg);
  }
  __syncthreads();
  int alive_out = 0;
  if (live) {
    int state = apply(excl, s_state);
    int o[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const uint32_t code = (codes >> (2 * k)) & 3;
      if (code == kIdentity) {
        o[k] = -1;  // tombstone or padding stays dead
      } else {
        // consumed by the merge the previous alive position starts, or
        // written: the pair's value where this position starts a merge
        o[k] = state ? -1 : w[k];
        alive_out += !state;
        state = code == 3 && !state;
      }
    }
    int4* dst = reinterpret_cast<int4*>(out + i0);
#pragma unroll
    for (int q = 0; q < kPer / 4; ++q) {
      dst[q] = make_int4(o[4 * q], o[4 * q + 1], o[4 * q + 2], o[4 * q + 3]);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    alive_out += __shfl_down_sync(0xffffffffu, alive_out, o);
  }
  if ((threadIdx.x & 31) == 0) warp_alive[threadIdx.x >> 5] = alive_out;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int w = 0; w < kThreads / 32; ++w) total += warp_alive[w];
    atomicAdd(count, total);
  }
}

}  // namespace

// tokens, out: cap int32 (16-byte aligned, cap a multiple of 16, checked by
// the wrapper); k1, v1, k2, v2: slots int32 each (slots a power of two);
// scratch: 2 * ceil(cap / 4096) + 2 int32, 8-byte aligned: the tiles'
// status words (uint64), the ticket, then the count (one int32, the second
// result). Returns the first nonzero CUDA error of the memset and the launch.
extern "C" int blt_token_pass_gap(const void* tokens, int cap, const void* k1,
                                  const void* v1, const void* k2,
                                  const void* v2, int slots, unsigned a1,
                                  unsigned a2, int shift, void* out,
                                  void* scratch, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  Planes t{(const int*)k1, (const int*)v1, (const int*)k2, (const int*)v2,
           a1, a2, shift, (uint32_t)(slots - 1)};
  GapPass b{(const int*)tokens, cap, t};
  int nt = (cap + kTile - 1) / kTile;
  int* words = (int*)scratch;
  int err = (int)cudaMemsetAsync(words, 0, (2 * nt + 2) * sizeof(int), s);
  if (err) return err;
  tile_lookback<<<nt, kThreads, 0, s>>>(
      b, (int*)out, words + 2 * nt + 1,
      reinterpret_cast<unsigned long long*>(words), words + 2 * nt);
  return (int)cudaGetLastError();
}

// CTAs of K3's round (tile_lookback) that one SM of the current
// device holds at once, as the CUDA runtime computes them from the compiled
// kernel's registers and shared memory. Returns the CUDA error of the query.
extern "C" int blt_token_pass_gap_ctas_per_sm(int* ctas) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas, tile_lookback, kThreads, 0);
}
