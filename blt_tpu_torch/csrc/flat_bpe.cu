// One flat-BPE pass over a byte batch, plus the packed-wire epilogue.
//
// Replaces: blt_tpu/ops/bpe_pallas.py::_flat_encode_pallas_call (kernel body
// _kernel_body, built by _make_kernel) and the XLA epilogue _pack_slots_core
// that _flat_encode_packed runs in the same dispatch; with other flag sets,
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
// 2 bytes of slots out, then 2 in and 1.125 out for the pack). The variants
// move the same bytes and measure what the lookup and the scan cost above
// them. Without the scan a pass is one launch (tile_emit); with it, three,
// or one with the look-back.
//
// Design: see flat_pass.cuh (reduce / one-block tile max-scan / emit on one
// stream, or one look-back launch; carries on the device). The table is the
// dense 64K-entry wire table (ops/tables.py): one gather serves every table
// size, so the four Pallas lookup layouts (chd, perfect, cuckoo, direct)
// collapse into one.

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
