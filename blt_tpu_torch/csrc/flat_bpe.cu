// One flat-BPE pass over a byte batch, plus the packed-wire epilogue, and
// the two fused into one launch.
//
// Replaces: blt_tpu/ops/bpe_pallas.py::_flat_encode_packed, the pass
// (_flat_encode_pallas_call, kernel body _kernel_body, built by
// _make_kernel) with the XLA epilogue _pack_slots_core in the same dispatch:
// flat_packed_kernel, the main path's flat pass; the pass and the epilogue
// on their own: blt_flat_pass and pack_kernel; with other flag sets,
// tools/exp_parts.py::chain (T8, body from make_variant_kernel), four
// variants of tools/exp_scan.py::_pallas (T6, body _variant_body), the four
// of tools/exp_opt.py::chain (T2) and two of tools/exp_chd.py::chain (T10).
//
// K2 is flat_pass.cuh with the lookup, the scan and no swap: the table ships
// pre-byteswapped values, so a start emits its table value as-is and a plain
// byte d<<8. The pack turns the slots into one byte per position plus an
// LSB-first flag plane (see bpe_pallas.pack_slots_device for the format).
//
// The ablations are flag sets of the same pass (bpe_cuda.FLAT_PASSES):
//   T8 (with kSwap: the tool emits byteswap(tok), so a start emits its value
//   swapped and a plain byte d<<8): emit (no lookup, no scan), noscan (no
//   scan), nolookup (no lookup), full (K2's function, starts swapped back
//   to the raw rule value). Without the lookup a pair matches when
//   (nxt & 7) == 0 and its value is d*256 + nxt (the tool's stand-in). The
//   Pallas variants probe the cuckoo segments inline; the wire table
//   computes the same function (rule value or none) in one gather.
//   T6: full (K2 itself), noscan (kOdd: a guessed parity), nolookup (no
//   lookup), noshifts (kRowWrap: the shifts stay inside each 128-byte row).
//   T6's scan16 and swarpack are scan_parts.cu.
//   T2 (body make_kernel; the tool's function is T8 full's): base is T8
//   full; p2 (kLookback: the cross-tile scan as a single-pass look-back),
//   p2+hoist (kLookback and kSmem: the table staged in shared memory on a
//   persistent grid), p2+hoist+swap (the same without kSwap, over a table
//   byteswapped once more).
//   T10 (body make_kernel): prod is K2 itself; novalid (!kValid: no
//   valid-pair mask). Its noscan2 is scan_parts.cu.
//
// Bound on the H100: the lookup and the scan, not the bytes. Each position
// costs one gather into a 128 KB table and a prefix maximum that makes every
// position depend on all earlier ones. The bytes moved are small (1 byte in,
// 2 bytes of slots out, then 2 in and 1.125 out for the pack; fused, 1 in
// and 1.125 out: 2.125 bytes a position, 10.6 us at 16 MiB). The variants
// move the same bytes and measure what the lookup and the scan cost above
// them. Without the scan a pass is one launch (tile_emit); with it, three,
// or one with the look-back.
//
// Design: see flat_pass.cuh (reduce / one-block tile max-scan / emit on one
// stream, or one look-back launch; carries on the device) and, for the fused
// pass, flat_packed_kernel below: the look-back launch, its emit packing the
// wire from registers, so that a batch is one launch, not four. The table
// is the dense 64K-entry wire table (ops/tables.py): one gather serves
// every table size, so the four Pallas lookup layouts (chd, perfect,
// cuckoo, direct) collapse into one.

#include "flat_pass.cuh"

namespace {

// The flag sets of bpe_cuda.FLAT_PASSES, the only ones instantiated
// (tests/test_torch_flat_opt.py holds the two lists equal): K2 131; T8 emit
// 132, noscan 133, nolookup 134, full 135; T6 noscan 137, nolookup 130,
// noshifts 147; T2 p2 167, hoist 231, swap 227; T10 novalid 3.
using FlatSets = std::integer_sequence<int, 131, 132, 133, 134, 135, 137, 130,
                                       147, 167, 231, 227, 3>;

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

// CTAs resident per SM for the fused pass: as K3's and K4's look-back
// rounds, registers are held to 40 a thread so that warps hide the lookups
// (4 and 8 ran slower, 8 spilled: PERF.md)
constexpr int kPackedBlocksPerSm = 6;

// Byte and flag of one position of the packed wire from its slot s and the
// slot p before it (pack_kernel's rule).
__device__ __forceinline__ uint32_t wire_byte(uint32_t s, uint32_t p, uint32_t& flag) {
  const bool start = (s & 0xFFu) != 0;
  const bool cons = (p & 0xFFu) != 0;
  flag = start || cons;
  return start ? (s & 0xFFu) : cons ? (p >> 8) : (s >> 8);
}

// K2 and its packed-wire epilogue in one launch: flag set 131 computed by
// the look-back protocol of tile_lookback (flat_pass.cuh), whose emit packs
// from registers where K2 stores slots. Slots never reach device memory:
// each thread keeps its 16 bytes (one uint4), their 16 pair values as u16
// (eight words) and the match and start bits, and writes 16 wire bytes (one
// uint4) and 16 flag bits (one u16 at wire[cap + i0 / 8]). The slot before
// a thread's first position is the previous thread's last (shared memory);
// before a tile's first position, only whether it is a start and its value
// matter to the pack (a consumed or plain slot has a zero low byte), so
// thread 0 looks the pair at i0 - 1 up once and the look-back prefix gives
// its start bit, as tile_emit's boundary rule does. Batch position 0 takes
// prev_slot. carry_out and last_slot (the raw slot at n-1, or prev_slot
// when n == 0) come from the thread that owns n-1.
__global__ void __launch_bounds__(kThreads, kPackedBlocksPerSm)
    flat_packed_kernel(Batch b, const int* __restrict__ carry_in,
                       const int* __restrict__ prev_slot, uint8_t* __restrict__ wire,
                       int* __restrict__ carry_out, int* __restrict__ last_slot,
                       unsigned long long* __restrict__ status,
                       int* __restrict__ ticket) {
  __shared__ int warp_tot[kThreads / 32];
  // each thread's last slot (low 16 bits) and whether it starts (bit 16)
  __shared__ uint32_t edge[kThreads];
  __shared__ int s_tile, s_prefix;
  __shared__ uint32_t s_prev;  // the slot before the tile, as edge[] holds it
  const int t = threadIdx.x;
  if (t == 0) s_tile = atomicAdd(ticket, 1);
  __syncthreads();
  const int tile = s_tile;
  const int tile0 = tile * kTile;
  const int i0 = tile0 + t * kPer;
  const bool live = i0 < b.cap;
  uint4 x = make_uint4(0, 0, 0, 0);
  uint32_t vals[kPer / 2] = {};
  uint32_t match = 0;
  if (live) {
    x = *reinterpret_cast<const uint4*>(b.data + i0);
    const uint32_t w[4] = {x.x, x.y, x.z, x.w};
    const int after = byte_after<false>(b, i0);
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int d = (w[k >> 2] >> (8 * (k & 3))) & 0xFF;
      const int nx = k + 1 < kPer ? (w[(k + 1) >> 2] >> (8 * ((k + 1) & 3))) & 0xFF : after;
      int v;
      match |= (uint32_t)pair_at<true>(b, i0 + k, d, nx, v) << k;
      vals[k >> 1] |= ((uint32_t)v & 0xFFFFu) << (16 * (k & 1));
    }
  }
  const int excl = block_excl_max<kThreads>(live ? last_nonmatch(i0, match) : kNeg, warp_tot);
  if (t == 0) {
    // the pair at i0 - 1 does not depend on the prefix: look it up first
    const int ip = tile0 - 1;
    int v = 0;
    const bool m = tile > 0 && pair_at<true>(b, ip, b.data[ip], b.data[tile0], v);
    const int prefix = look_back(status, tile, tile_max(warp_tot), -1 - carry_in[0]);
    s_prefix = prefix;
    if (tile == 0) {
      s_prev = ((uint32_t)prev_slot[0] & 0xFFFFu) | ((uint32_t)(carry_in[0] != 0) << 16);
    } else {
      const bool start = m && ((ip - prefix) & 1);
      s_prev = start ? ((uint32_t)v & 0xFFFFu) | (1u << 16) : 0u;
    }
  }
  __syncthreads();
  const uint32_t starts = scan_starts(i0, match, max(s_prefix, excl));
  const uint32_t w[4] = {x.x, x.y, x.z, x.w};
  // slot k of this thread: 0 where consumed, the pair's value where it
  // starts, else the byte << 8
  auto slot = [&](int k, uint32_t consumed) -> uint32_t {
    if ((consumed >> k) & 1u) return 0u;
    if ((starts >> k) & 1u) return (vals[k >> 1] >> (16 * (k & 1))) & 0xFFFFu;
    return ((w[k >> 2] >> (8 * (k & 3))) & 0xFFu) << 8;
  };
  const uint32_t prev_start = (starts >> (kPer - 1)) & 1u;
  // the 16th slot needs only the 15th start bit: consumed there is bit 14
  edge[t] = slot(kPer - 1, starts << 1) | (prev_start << 16);
  __syncthreads();
  if (!live) return;
  const uint32_t before = t > 0 ? edge[t - 1] : s_prev;
  const uint32_t consumed = (starts << 1) | (before >> 16);
  uint32_t p = before & 0xFFFFu;
  uint32_t bytes[4] = {0u, 0u, 0u, 0u};
  uint32_t flags = 0;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const uint32_t s = slot(k, consumed);
    uint32_t f;
    bytes[k >> 2] |= wire_byte(s, p, f) << (8 * (k & 3));
    flags |= f << k;
    p = s;
  }
  *reinterpret_cast<uint4*>(wire + i0) = make_uint4(bytes[0], bytes[1], bytes[2], bytes[3]);
  *reinterpret_cast<uint16_t*>(wire + b.cap + i0 / 8) = (uint16_t)flags;
  const int last = b.n - 1;
  if (last >= i0 && last < i0 + kPer) {
    carry_out[0] = (starts >> (last - i0)) & 1u;
    last_slot[0] = (int)slot(last - i0, consumed);
  }
  if (b.n == 0 && i0 == 0) {
    carry_out[0] = carry_in[0];
    last_slot[0] = prev_slot[0];
  }
}

}  // namespace

// flags: the FlatFlag bits of flat_pass.cuh (lookup 1, scan 2, swap 4,
// odd 8, row_wrap 16, lookback 32, smem_table 64, valid 128; K2 is 131).
// data: cap bytes; table: 65536 u16; carry_in, carry_out: one int32 each;
// slots: cap u16; scratch: 2 * ceil(cap / 4096) + 2 int32. Pointers to
// data, table and slots are 16-byte aligned and cap is a multiple of 16, of
// 128 with row_wrap (checked by the wrapper). Returns the first nonzero CUDA
// error of the launches, or cudaErrorInvalidValue for a set not in FlatSets.
extern "C" int blt_flat_pass(int flags, const void* data, int cap, int n,
                             int next_byte, const void* table,
                             const void* carry_in, void* slots,
                             void* carry_out, void* scratch, void* stream) {
  Batch b{(const uint8_t*)data, (const uint16_t*)table, cap, n, next_byte};
  return dispatch_flat_pass(flags, FlatSets(),
                            b, (const int*)carry_in, (uint16_t*)slots,
                            (int*)carry_out, (int*)scratch,
                            (cudaStream_t)stream);
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

// K2 and its pack in one launch (flat_packed_kernel). data: cap bytes;
// table: 65536 u16; carry_in, prev_slot, carry_out, last_slot: one int32
// each; wire: cap + cap / 8 bytes; scratch: 2 * ceil(cap / 4096) + 1 int32:
// the tiles' status words (uint64), then the ticket. data, table and wire
// are 16-byte aligned, scratch 8-byte, and cap is a positive multiple of 16
// (checked by the wrapper). Returns the first nonzero CUDA error of the
// memset and the launch.
extern "C" int blt_flat_packed(const void* data, int cap, int n, int next_byte,
                               const void* table, const void* carry_in,
                               const void* prev_slot, void* wire, void* carry_out,
                               void* last_slot, void* scratch, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  Batch b{(const uint8_t*)data, (const uint16_t*)table, cap, n, next_byte};
  int nt = (cap + kTile - 1) / kTile;
  int err = (int)cudaMemsetAsync(scratch, 0, (2 * nt + 1) * sizeof(int), s);
  if (err) return err;
  flat_packed_kernel<<<nt, kThreads, 0, s>>>(
      b, (const int*)carry_in, (const int*)prev_slot, (uint8_t*)wire, (int*)carry_out,
      (int*)last_slot, reinterpret_cast<unsigned long long*>(scratch),
      (int*)scratch + 2 * nt);
  return (int)cudaGetLastError();
}

// CTAs of the fused pass (flat_packed_kernel) that one SM of the current
// device holds at once, as the CUDA runtime computes them from the compiled
// kernel's registers and shared memory. Returns the CUDA error of the query.
extern "C" int blt_flat_packed_ctas_per_sm(int* ctas) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas, flat_packed_kernel, kThreads, 0);
}
