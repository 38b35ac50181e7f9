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
// or two dependent gathers into the 128 KB of planes, which the read-only
// cache holds.
//
// Design: the Pallas grid carries the composition state from block to block
// in SMEM; CUDA blocks run in no order. So, as flat_bpe.cu does for its max,
// the composition scan is three launches on one stream with no host sync:
// tile_reduce (each 4096-position tile's composed code), tile_scan (one
// block composes the tiles in order and writes the state entering each, and
// zeroes the count) and tile_emit (recompute, scan inside the tile with
// order-keeping warp shuffles, write with 16-byte stores, add the tile's
// alive count with one atomic). Each thread owns 16 consecutive tokens,
// loaded as four int4, plus the next four as a fifth int4.

#include <cstdint>
#include <cuda_runtime.h>

#include "cuckoo32.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 16;                // positions per thread
constexpr int kTile = kThreads * kPer;  // positions per block
constexpr int kLook = 4;                // _GAP_LOOKAHEAD
constexpr int kScanThreads = 1024;
constexpr int kIdentity = 2;

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

// Loads the 16 tokens at i0 (and the 4 after them) and computes each
// position's pair value and code. False past cap.
__device__ __forceinline__ bool load_codes(const GapPass& b, int i0,
                                           int d[kPer], int val[kPer],
                                           int code[kPer]) {
  if (i0 >= b.cap) return false;
  int w[kPer + kLook];
  const int4* src = reinterpret_cast<const int4*>(b.tok + i0);
#pragma unroll
  for (int q = 0; q < (kPer + kLook) / 4; ++q) {
    int4 x = (q < kPer / 4 || i0 + kPer < b.cap) ? src[q]
                                                 : make_int4(-1, -1, -1, -1);
    w[4 * q] = x.x;
    w[4 * q + 1] = x.y;
    w[4 * q + 2] = x.z;
    w[4 * q + 3] = x.w;
  }
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    int nx = w[k + 1];
#pragma unroll
    for (int j = 2; j <= kLook; ++j) {
      if (nx < 0) nx = w[k + j];
    }
    d[k] = w[k];
    bool alive = d[k] >= 0;
    val[k] = (alive && nx >= 0) ? cuckoo32_lookup(b.t, d[k], nx) : -1;
    code[k] = !alive ? kIdentity : (val[k] >= 0 ? 3 : 0);
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

__device__ __forceinline__ int thread_code(const int code[kPer]) {
  int f = kIdentity;
#pragma unroll
  for (int k = 0; k < kPer; ++k) f = compose(code[k], f);
  return f;
}

__global__ void __launch_bounds__(kThreads)
    tile_reduce(GapPass b, int* __restrict__ tile_code) {
  __shared__ int warp_tot[kThreads / 32];
  int i0 = blockIdx.x * kTile + threadIdx.x * kPer;
  int d[kPer], val[kPer], code[kPer];
  int f = load_codes(b, i0, d, val, code) ? thread_code(code) : kIdentity;
  int excl = block_excl_compose<kThreads>(f, warp_tot);
  if (threadIdx.x == kThreads - 1) tile_code[blockIdx.x] = compose(f, excl);
}

__global__ void __launch_bounds__(kScanThreads)
    tile_scan(const int* __restrict__ tile_code, int* __restrict__ tile_state,
              int nt, int* __restrict__ count) {
  __shared__ int warp_tot[kScanThreads / 32];
  int per = (nt + kScanThreads - 1) / kScanThreads;
  int lo = threadIdx.x * per;
  int hi = min(nt, lo + per);
  int local = kIdentity;
  for (int j = lo; j < hi; ++j) local = compose(tile_code[j], local);
  // the state entering the buffer is 0: no merge started before it
  int state = apply(block_excl_compose<kScanThreads>(local, warp_tot), 0);
  for (int j = lo; j < hi; ++j) {
    tile_state[j] = state;
    state = apply(tile_code[j], state);
  }
  if (threadIdx.x == 0) count[0] = 0;  // tile_emit adds to it
}

__global__ void __launch_bounds__(kThreads)
    tile_emit(GapPass b, const int* __restrict__ tile_state,
              int* __restrict__ out, int* __restrict__ count) {
  __shared__ int warp_tot[kThreads / 32];
  __shared__ int warp_alive[kThreads / 32];
  int i0 = blockIdx.x * kTile + threadIdx.x * kPer;
  int d[kPer], val[kPer], code[kPer];
  bool live = load_codes(b, i0, d, val, code);
  int f = live ? thread_code(code) : kIdentity;
  int excl = block_excl_compose<kThreads>(f, warp_tot);
  int alive_out = 0;
  if (live) {
    int state = apply(excl, tile_state[blockIdx.x]);
    int o[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      if (code[k] == kIdentity) {
        o[k] = -1;  // tombstone or padding stays dead
      } else {
        bool start = code[k] == 3 && !state;
        o[k] = state ? -1 : (start ? val[k] : d[k]);
        alive_out += !state;
        state = start;
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
// count: one int32; scratch: 2 * ceil(cap / 4096) int32. Returns the first
// nonzero cudaGetLastError() of the launches.
extern "C" int blt_token_pass_gap(const void* tokens, int cap, const void* k1,
                                  const void* v1, const void* k2,
                                  const void* v2, int slots, unsigned a1,
                                  unsigned a2, int shift, void* out,
                                  void* count, void* scratch, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  Planes t{(const int*)k1, (const int*)v1, (const int*)k2, (const int*)v2,
           a1, a2, shift, (uint32_t)(slots - 1)};
  GapPass b{(const int*)tokens, cap, t};
  int nt = (cap + kTile - 1) / kTile;
  int* tile_code = (int*)scratch;
  int* tile_state = tile_code + nt;
  tile_reduce<<<nt, kThreads, 0, s>>>(b, tile_code);
  int err = (int)cudaGetLastError();
  if (err) return err;
  tile_scan<<<1, kScanThreads, 0, s>>>(tile_code, tile_state, nt, (int*)count);
  err = (int)cudaGetLastError();
  if (err) return err;
  tile_emit<<<nt, kThreads, 0, s>>>(b, tile_state, (int*)out, (int*)count);
  return (int)cudaGetLastError();
}
