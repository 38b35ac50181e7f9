// The flat-BPE pass's cost split: four variants of K2 that drop the lookup,
// the scan, or both, with the same bytes in and out.
//
// Replaces: tools/exp_parts.py::chain (its pallas_call `call`, kernel body
// from make_variant_kernel), the Pallas kernel that splits _kernel_body's
// time into lookup, scan and emit.
//
// Variants (flat_pass.cuh with kSwap: the tool emits byteswap(tok), so a
// start emits its value swapped and a plain byte d<<8):
//   0 emit:     no lookup (m = (nxt & 7) == 0, val = d*256 + nxt), no scan;
//   1 noscan:   the wire-table lookup, start = m;
//   2 nolookup: the trivial match, the scan;
//   3 full:     the lookup and the scan (K2's function, with starts swapped
//               back to the raw rule value).
// The Pallas variants probe the cuckoo segments inline; the wire table
// computes the same function (rule value or none) in one gather.
//
// Bound on the H100: the bytes are K2's (1 byte in, 2 bytes of slots out,
// plus the 128 KB table for the lookup variants); the variants measure
// what the lookup and the scan cost above them. Without the scan a pass is
// one launch (tile_emit); with it, three.

#include "flat_pass.cuh"

// variant: 0 emit, 1 noscan, 2 nolookup, 3 full. Other arguments as
// blt_flat_bpe (flat_bpe.cu). Returns the first nonzero cudaGetLastError()
// of the launches, or cudaErrorInvalidValue for an unknown variant.
extern "C" int blt_flat_parts(int variant, const void* data, int cap, int n,
                              int next_byte, const void* table,
                              const void* carry_in, void* slots,
                              void* carry_out, void* scratch, void* stream) {
  Batch b{(const uint8_t*)data, (const uint16_t*)table, cap, n, next_byte};
  const int* c_in = (const int*)carry_in;
  uint16_t* out = (uint16_t*)slots;
  int* c_out = (int*)carry_out;
  int* sc = (int*)scratch;
  cudaStream_t s = (cudaStream_t)stream;
  switch (variant) {
    case 0: return launch_flat_pass<false, false, true>(b, c_in, out, c_out, sc, s);
    case 1: return launch_flat_pass<true, false, true>(b, c_in, out, c_out, sc, s);
    case 2: return launch_flat_pass<false, true, true>(b, c_in, out, c_out, sc, s);
    case 3: return launch_flat_pass<true, true, true>(b, c_in, out, c_out, sc, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
