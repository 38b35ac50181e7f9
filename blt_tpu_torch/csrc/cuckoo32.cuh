// Two-plane cuckoo32 lookup of general-table pair keys, shared by the token
// passes (token_pass.cu, token_pass_gap.cu).
//
// The function of the Pallas kernels' lookup (blt_tpu/ops/bpe_pallas.py,
// _token_pass_kernel and _token_pass_gap_kernel, over the planes that
// MergeTable.build_cuckoo32 places, or the wide planes that
// ops/tables.py cuckoo32_placement places for a table of more than 8192
// rules):
//   p   = d * 65536 + nxt               (wrapped to int32)
//   h_j = ((p * a_j) >> shift) & (slots - 1)
//   hit_j = k_j[h_j] == p && v_j[h_j] >= 0, and plane 1 wins.
//
// int32 wrap: the JAX code wraps on purpose in d*65536 + nxt and in p*a_j.
// Signed overflow is undefined in C++, so both are computed in uint32_t, which
// gives the same bits. The shift is logical here and arithmetic in JAX; the
// mask keeps exactly 32 - shift bits, all below the bits where the two shifts
// differ, so the slot is the same.

#pragma once

#include <cstdint>

struct Planes {
  const int* k1;  // key plane 1, int32[slots]
  const int* v1;  // value plane 1, -1 = empty slot
  const int* k2;
  const int* v2;
  uint32_t a1;    // odd multipliers of the two hashes
  uint32_t a2;
  int shift;      // 32 - log2(slots)
  uint32_t mask;  // slots - 1
};

// Rule value of the pair (d, nx), or -1 when the table has no rule for it
// (rule values are u16, so -1 is never a value). The planes are read through
// __ldg: the default 8192 slots' 128 KB stay in the read-only cache, a wide
// table's 1 MiB (65,536 slots) is read through L2. Both planes' words are
// loaded before either compare: one round trip to the cache a lookup where
// plane 1 misses, not two, for two more loads where it hits. The rounds
// that use it are bound by their lookups, not their bytes, and each ran
// faster so on the card (PERF.md, PR 11).
__device__ __forceinline__ int cuckoo32_lookup(const Planes& t, int d, int nx) {
  uint32_t p = ((uint32_t)d << 16) + (uint32_t)nx;
  uint32_t h1 = ((p * t.a1) >> t.shift) & t.mask;
  uint32_t h2 = ((p * t.a2) >> t.shift) & t.mask;
  int k1 = __ldg(t.k1 + h1);
  int v1 = __ldg(t.v1 + h1);
  int k2 = __ldg(t.k2 + h2);
  int v2 = __ldg(t.v2 + h2);
  if (k1 == (int)p && v1 >= 0) return v1;
  if (k2 == (int)p && v2 >= 0) return v2;
  return -1;
}
