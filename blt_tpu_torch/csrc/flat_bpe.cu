// One flat-BPE pass over a byte batch, plus the packed-wire epilogue.
//
// Replaces: blt_tpu/ops/bpe_pallas.py::_flat_encode_pallas_call (kernel body
// _kernel_body, built by _make_kernel) and the XLA epilogue _pack_slots_core
// that _flat_encode_packed runs in the same dispatch.
//
// Per position i of a batch with n valid bytes (the same function as
// _kernel_body):
//   nxt   = data[i+1], or max(next_byte, 0) at i == n-1
//   val   = table[d*256 + nxt]         (pre-byteswapped u16, 0 = no rule)
//   m     = val != 0 && (i < n-1 || (i == n-1 && next_byte >= 0))
//   lz    = max(-1 - carry_in, last j <= i with !m[j])
//   start = m && ((i - lz) & 1)        (leftmost-first, non-overlapping)
//   consumed = start[i-1], or carry_in at i == 0
//   slot  = consumed ? 0 : (start ? val : d << 8)
//   carry_out = n > 0 ? start[n-1] : carry_in
// The pack turns the slots into one byte per position plus an LSB-first
// flag plane (see bpe_pallas.pack_slots_device for the format).
//
// Bound on the H100: the lookup and the scan, not the bytes. Each position
// costs one gather into a 128 KB table and a prefix maximum that makes every
// position depend on all earlier ones. The bytes moved are small (1 byte in,
// 2 bytes of slots out, then 2 in and 1.125 out for the pack).
//
// Design: the Pallas kernel carries the block-to-block state in SMEM because
// a TPU grid runs in order. CUDA blocks run in no order, so the prefix
// maximum is split into three launches on one stream, with no host sync:
//   1. tile_reduce: each 4096-position tile records its last non-match
//      index (or kNeg);
//   2. tile_scan: one block takes the exclusive max-scan over the tiles,
//      seeded with the sentinel -1 - carry_in;
//   3. tile_emit: each tile recomputes its lookups, scans within the tile
//      (warp shuffles), writes its slots with 16-byte stores, and the thread
//      that owns n-1 writes carry_out.
// The table is the dense 64K-entry wire table (ops/tables.py), read through
// the read-only data cache: one gather serves every table size, so the four
// Pallas lookup layouts (chd, perfect, cuckoo, direct) collapse into one.
// Each thread owns 16 consecutive positions, loaded as one uint4.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 16;                // positions per thread
constexpr int kTile = kThreads * kPer;  // positions per block
constexpr int kScanThreads = 1024;
constexpr int kNeg = -2147483647;       // -(2^31) + 1, the Pallas _NEG

struct Batch {
  const uint8_t* data;
  const uint16_t* table;
  int cap;        // positions in the buffer (a multiple of 16)
  int n;          // valid positions
  int next_byte;  // first byte of the next batch, -1 at end of stream
};

// Rule value of the pair that starts at position i (0: no merge may start).
__device__ __forceinline__ int pair_val(const Batch& b, int i, int d, int nx) {
  if (i < b.n - 1) {
    // the pair lies inside the batch
  } else if (i == b.n - 1 && b.next_byte >= 0) {
    nx = b.next_byte;
  } else {
    return 0;
  }
  return __ldg(b.table + ((d << 8) | nx));
}

// Loads the 16 bytes at i0 and looks up their 16 pairs. False past cap.
__device__ __forceinline__ bool load_vals(const Batch& b, int i0, int d[kPer],
                                          int val[kPer]) {
  if (i0 >= b.cap) return false;
  uint4 x = *reinterpret_cast<const uint4*>(b.data + i0);
  uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int k = 0; k < kPer; ++k) d[k] = (w[k >> 2] >> (8 * (k & 3))) & 0xFF;
  int after = i0 + kPer < b.cap ? b.data[i0 + kPer] : 0;
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
    tile_reduce(Batch b, int* __restrict__ tile_lnm) {
  __shared__ int warp_max[kThreads / 32];
  int i0 = blockIdx.x * kTile + threadIdx.x * kPer;
  int d[kPer], val[kPer];
  int mx = kNeg;
  if (load_vals(b, i0, d, val)) {
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      if (val[k] == 0) mx = i0 + k;
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

__global__ void __launch_bounds__(kThreads)
    tile_emit(Batch b, const int* __restrict__ tile_excl,
              const int* __restrict__ carry_in, uint16_t* __restrict__ slots,
              int* __restrict__ carry_out) {
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
      if (val[k] == 0) mx = i0 + k;
    }
  }
  int tile_prefix = tile_excl[blockIdx.x];  // holds the sentinel too
  int run = max(tile_prefix, block_excl_max<kThreads>(mx, warp_tot));
  uint32_t starts = 0;
  if (live) {
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      int i = i0 + k;
      if (val[k] == 0) {
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
    prev_start = carry_in[0] != 0;
  } else {
    // the previous tile's last position: its lz is this tile's prefix
    int ip = tile0 - 1;
    int v = pair_val(b, ip, b.data[ip], b.data[tile0]);
    prev_start = v != 0 && ((ip - tile_prefix) & 1);
  }
  uint32_t consumed = (starts << 1) | prev_start;

  uint32_t w[kPer / 2];
#pragma unroll
  for (int j = 0; j < kPer / 2; ++j) {
    uint32_t s[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int k = 2 * j + h;
      s[h] = ((consumed >> k) & 1u)  ? 0u
             : ((starts >> k) & 1u) ? (uint32_t)val[k]
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

__global__ void pack_kernel(const uint16_t* __restrict__ slots, int cap, int n,
                            const int* __restrict__ prev_slot,
                            uint8_t* __restrict__ wire,
                            int* __restrict__ last_slot) {
  int groups = cap / 8;
  int stride = gridDim.x * blockDim.x;
  int gid = blockIdx.x * blockDim.x + threadIdx.x;
  for (int g = gid; g < groups; g += stride) {
    uint4 x = *reinterpret_cast<const uint4*>(slots + 8 * g);
    uint32_t w[4] = {x.x, x.y, x.z, x.w};
    int prev = g == 0 ? prev_slot[0] : slots[8 * g - 1];
    uint32_t bytes[2] = {0u, 0u};
    uint32_t flags = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      int s = (w[j >> 1] >> (16 * (j & 1))) & 0xFFFF;
      bool start = (s & 0xFF) != 0;
      bool cons = (prev & 0xFF) != 0;
      uint32_t byte = start ? (s & 0xFF) : cons ? ((prev >> 8) & 0xFF) : (s >> 8);
      bytes[j >> 2] |= byte << (8 * (j & 3));
      flags |= (uint32_t)(start || cons) << j;
      prev = s;
    }
    *reinterpret_cast<uint2*>(wire + 8 * g) = make_uint2(bytes[0], bytes[1]);
    wire[cap + g] = (uint8_t)flags;
    int last = n - 1;
    if (last >= 8 * g && last < 8 * g + 8) {
      last_slot[0] = (w[(last - 8 * g) >> 1] >> (16 * ((last - 8 * g) & 1))) & 0xFFFF;
    }
  }
  if (n == 0 && gid == 0) last_slot[0] = prev_slot[0];
}

}  // namespace

// data: cap bytes; table: 65536 u16; carry_in, carry_out: one int32 each;
// slots: cap u16; scratch: 2 * ceil(cap / 4096) int32. Pointers to data and
// slots are 16-byte aligned and cap is a multiple of 16 (checked by the
// wrapper). Returns the first nonzero cudaGetLastError() of the launches.
extern "C" int blt_flat_bpe(const void* data, int cap, int n, int next_byte,
                            const void* table, const void* carry_in,
                            void* slots, void* carry_out, void* scratch,
                            void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  Batch b{(const uint8_t*)data, (const uint16_t*)table, cap, n, next_byte};
  int nt = (cap + kTile - 1) / kTile;
  int* tile_lnm = (int*)scratch;
  int* tile_excl = tile_lnm + nt;
  tile_reduce<<<nt, kThreads, 0, s>>>(b, tile_lnm);
  int err = (int)cudaGetLastError();
  if (err) return err;
  tile_scan<<<1, kScanThreads, 0, s>>>(tile_lnm, tile_excl, nt,
                                       (const int*)carry_in);
  err = (int)cudaGetLastError();
  if (err) return err;
  tile_emit<<<nt, kThreads, 0, s>>>(b, tile_excl, (const int*)carry_in,
                                    (uint16_t*)slots, (int*)carry_out);
  return (int)cudaGetLastError();
}

// slots: cap u16 (16-byte aligned, cap a multiple of 8); prev_slot and
// last_slot: one int32 each; wire: cap + cap / 8 bytes (8-byte aligned).
extern "C" int blt_pack_slots(const void* slots, int cap, int n,
                              const void* prev_slot, void* wire,
                              void* last_slot, void* stream) {
  int groups = cap / 8;
  int want = (groups + 255) / 256;
  int blocks = want < 1 ? 1 : (want < 132 * 16 ? want : 132 * 16);
  pack_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(
      (const uint16_t*)slots, cap, n, (const int*)prev_slot, (uint8_t*)wire,
      (int*)last_slot);
  return (int)cudaGetLastError();
}
