// One general-table merge round over compacted int32 tokens (K4).
//
// Replaces: blt_tpu/ops/bpe_pallas.py::_token_pass_call (kernel body
// _token_pass_kernel), the pass that _multipass_resident_call (the
// BLT_MP_COMPACT=sort loop) and PallasTokenEncoder.encode run once per round.
//
// Per position i of a buffer of cap tokens with n valid (the function of
// _token_pass_kernel, with the carry 0 at the start of the call: general
// tables have per-chunk semantics):
//   nxt   = tok[i+1]
//   val   = cuckoo32 lookup of (tok[i], nxt), -1 = no rule (cuckoo32.cuh)
//   m     = val >= 0 && i < n-1
//   lz    = max(-1, last j <= i with !m[j])
//   start = m && ((i - lz) & 1)        (leftmost-first, non-overlapping)
//   consumed = start[i-1] (false at i == 0)
//   out   = consumed ? -1 : (start ? val : tok[i])
// The Pallas input's 8 halo rows are a BlockSpec artefact and are dropped:
// the buffer is cap tokens, and no position past n-1 can start a merge.
//
// Bound on the H100: the bytes, 4 in and 4 out per position (64 MiB each way
// at 16 Mi tokens, about 40 us at 3.35 TB/s). Each position also costs one or
// two dependent gathers into the 128 KB of planes (at 8192 slots), which the
// read-only cache holds.
//
// Design: the Pallas grid carries the parity from block to block in SMEM
// because a TPU grid runs in order. CUDA blocks run in no order, so the
// prefix maximum is split into three launches on one stream, with no host
// sync, as in flat_bpe.cu: tile_reduce (each 4096-position tile's last
// non-match), tile_scan (one block's exclusive max-scan over the tiles,
// seeded with -1) and tile_emit (recompute the lookups, scan inside the
// tile with warp shuffles, write with 16-byte stores). Each thread owns 16
// consecutive tokens, loaded as four int4.

#include <cstdint>
#include <cuda_runtime.h>

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

// Rule value of the pair that starts at i, or -1 where no merge may start.
__device__ __forceinline__ int pair_val(const Pass& b, int i, int d, int nx) {
  return i < b.n - 1 ? cuckoo32_lookup(b.t, d, nx) : -1;
}

// Loads the 16 tokens at i0 and looks up their pairs. False past cap.
__device__ __forceinline__ bool load_vals(const Pass& b, int i0, int d[kPer],
                                          int val[kPer]) {
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
  int after = i0 + kPer < b.cap ? b.tok[i0 + kPer] : 0;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    val[k] = pair_val(b, i0 + k, d[k], k + 1 < kPer ? d[k + 1] : after);
  }
  return true;
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

__global__ void __launch_bounds__(kThreads)
    tile_reduce(Pass b, int* __restrict__ tile_lnm) {
  __shared__ int warp_max[kThreads / 32];
  int i0 = blockIdx.x * kTile + threadIdx.x * kPer;
  int d[kPer], val[kPer];
  int mx = kNeg;
  if (load_vals(b, i0, d, val)) {
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      if (val[k] < 0) mx = i0 + k;
    }
  }
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

__global__ void __launch_bounds__(kThreads)
    tile_emit(Pass b, const int* __restrict__ tile_excl, int* __restrict__ out) {
  __shared__ int warp_tot[kThreads / 32];
  __shared__ unsigned char last_start[kThreads];
  int t = threadIdx.x;
  int tile0 = blockIdx.x * kTile;
  int i0 = tile0 + t * kPer;
  int d[kPer], val[kPer];
  bool live = load_vals(b, i0, d, val);
  int mx = kNeg;
  if (live) {
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      if (val[k] < 0) mx = i0 + k;
    }
  }
  int tile_prefix = tile_excl[blockIdx.x];  // holds the sentinel too
  int run = max(tile_prefix, block_excl_max<kThreads>(mx, warp_tot));
  uint32_t starts = 0;
  if (live) {
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      int i = i0 + k;
      if (val[k] < 0) {
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
    // the previous tile's last position: its lz is this tile's prefix
    int ip = tile0 - 1;
    int v = pair_val(b, ip, b.tok[ip], b.tok[tile0]);
    prev_start = v >= 0 && ((ip - tile_prefix) & 1);
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

}  // namespace

// tokens, out: cap int32 (16-byte aligned, cap a multiple of 16, checked by
// the wrapper); k1, v1, k2, v2: slots int32 each (slots a power of two);
// scratch: 2 * ceil(cap / 4096) int32. Returns the first nonzero
// cudaGetLastError() of the launches.
extern "C" int blt_token_pass(const void* tokens, int cap, int n,
                              const void* k1, const void* v1, const void* k2,
                              const void* v2, int slots, unsigned a1,
                              unsigned a2, int shift, void* out, void* scratch,
                              void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  Planes t{(const int*)k1, (const int*)v1, (const int*)k2, (const int*)v2,
           a1, a2, shift, (uint32_t)(slots - 1)};
  Pass b{(const int*)tokens, cap, n, t};
  int nt = (cap + kTile - 1) / kTile;
  int* tile_lnm = (int*)scratch;
  int* tile_excl = tile_lnm + nt;
  tile_reduce<<<nt, kThreads, 0, s>>>(b, tile_lnm);
  int err = (int)cudaGetLastError();
  if (err) return err;
  tile_scan<<<1, kScanThreads, 0, s>>>(tile_lnm, tile_excl, nt);
  err = (int)cudaGetLastError();
  if (err) return err;
  tile_emit<<<nt, kThreads, 0, s>>>(b, tile_excl, (int*)out);
  return (int)cudaGetLastError();
}
