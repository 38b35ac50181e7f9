// The flat-BPE pass's ablations with the parity scan run block by block,
// and a block-local parity scan of a bare match mask:
//   T6's scan16 and swarpack (block_scan, block_fixup),
//   T10's noscan2 (row_carry_map, walk_carries, row_scan_emit),
//   T12's scan in int32 and in bf16x2 (mask_scan).
//
// Replaces: tools/exp_scan.py::_pallas (kernel body _variant_body) for
// scan16 and swarpack; tools/exp_chd.py::chain (body make_kernel) for
// noscan2; tools/exp_bf16scan.py::chain (bodies _scan_i32_kernel and
// _scan_bf16_kernel). T6's other four variants and T10's prod and novalid
// are flag sets of the flat pass, blt_flat_pass (flat_bpe.cu).
//
// scan16, swarpack and noscan2 take K2's arguments and the dense wire table
// in place of the tools' CHD probe (the same function: the pre-byteswapped
// rule value or no rule), emit values unswapped (as K2) and write
// carry_out = start[n-1] (carry_in when n == 0):
//   scan16:     start = m && ((i & 1) ^ p), p the parity of the last
//               non-match at or before i within i's block of rpb rows, 1 if
//               there is none: full's function except where a block opens
//               with a run of matches after a start (the tool's 16-bit row
//               scan keeps no carry between blocks);
//   swarpack:   the tool's SWAR-packed scan. In each block, row pair
//               (2q, 2q+1) is packed as code_2q | code_2q+1 << 16 per lane,
//               code = m ? 0 : (lane+1)*2 + (lane & 1); 7 Hillis-Steele
//               steps s = (s & k) | (c & ~k), c = s at lane - sh (0 below
//               sh), g = ((s | 0x80008000) - c) & 0x80008000,
//               k = (g - (g >> 15)) | g, all in int32 (>> arithmetic). Row r
//               then reads field f of packed row r mod (rpb/2): the low half
//               for r < rpb/2, the high half after (the tool's
//               concatenate([se, so])); p = f & 1 where f > 0, else the
//               parity of the last non-match in the earlier rows of the
//               block (1 if none); start = m && ((i & 1) ^ p). The tool's
//               docstring calls this deliberately approximate; this is
//               exactly what it computes.
//   noscan2:    the scan's first phase alone: lz = max(the last non-match
//               at or before i within i's 128-byte row, s - 1 - c), s the
//               first position of i's block of rpb rows and c the block's
//               carry; start = m && ((i - lz) & 1). A block's carry is the
//               previous block's start at its last position (min(block end,
//               n - 1)), the call's carry_in for block 0, and passes
//               through a block with no position below n: the Pallas grid's
//               SMEM carry, a true chain from block to block.
// In scan16 and swarpack consumed = start[i-1], or carry_in at i == 0; in
// noscan2 consumed at a block's first position is the block's carry. The
// next byte of a block's last position is the next block's first byte.
//
// mask_scan (T12) takes a u8 mask of whole blocks of rpb rows x 128 and
// writes u8 starts: per block, start = m && ((i - lz) & 1), lz the last
// zero of the mask at or before i within the block, -1 if none (a
// block-local scan with carry 0; blocks are even-sized, so i's parity is its
// lane's). The int32 and bf16 variants compute this one function; bf16 runs
// the lane scan on lane indices (-1..127, exact in bf16) two lanes to a
// 32-bit register with __hmax2, the card's analogue of the tool's question
// whether 16-bit values packed two to a lane scan faster.
//
// Bound on the H100: the bytes. The flat variants read 1 byte and write 2
// bytes of slots per position plus the 128 KB table (192 MiB at 64 MiB,
// about 60 us at 3.35 TB/s); mask_scan reads 1 and writes 1 (128 MiB at
// 64 MiB, about 40 us).
//
// Design: all are block-local, so one CUDA block of 256 threads takes one
// Pallas block of rpb rows, a warp per row and 4 lanes per thread, in steps
// with shared memory between them (the match bits of each row, and what a
// step needs of the rows before):
//   scan16, swarpack (36 bytes per row): the match bits and each row's last
//   non-match, the exclusive max over the rows, the start bits, then the
//   slots with 8-byte stores (the batch is read and looked up twice); a
//   second launch applies consumed at each block's first position, which
//   needs the previous block's last start (or carry_in).
//   noscan2: three launches on one stream. row_carry_map: a warp per block
//   records the block's carry out for carry in 0 and for 1 (only the row of
//   its last position can depend on it, through the sentinel);
//   walk_carries: one thread walks the blocks from carry_in; row_scan_emit:
//   each block's starts (16 bytes per row) and slots with its carry.
//   mask_scan (20 bytes per row): the match bits and each row's last zero,
//   the exclusive max over the rows, then the starts with 4-byte stores.

#include <cuda_bf16.h>

#include "flat_pass.cuh"

namespace {

constexpr int kWarps = kThreads / 32;
constexpr uint32_t kFull = 0xffffffffu;

// 4 bits per thread -> the row's four 32-bit words; thread 8w writes word w.
__device__ __forceinline__ void put_nibbles(uint32_t* row_words, uint32_t nib,
                                            int lane) {
  uint32_t word = nib << (4 * (lane & 7));
  word |= __shfl_xor_sync(kFull, word, 1);
  word |= __shfl_xor_sync(kFull, word, 2);
  word |= __shfl_xor_sync(kFull, word, 4);
  if ((lane & 7) == 0) row_words[lane >> 3] = word;
}

__device__ __forceinline__ uint32_t get_nibble(const uint32_t* row_words,
                                               int lane) {
  return (row_words[lane >> 3] >> (4 * (lane & 7))) & 0xFu;
}

// The 4 bytes a thread owns and the byte after them in stream order.
__device__ __forceinline__ void load4(const Batch& b, int i0, int lane,
                                      int d[4], int& after) {
  uint32_t w = *reinterpret_cast<const uint32_t*>(b.data + i0);
#pragma unroll
  for (int q = 0; q < 4; ++q) d[q] = (w >> (8 * q)) & 0xFF;
  after = __shfl_down_sync(kFull, d[0], 1);
  if (lane == 31) after = i0 + 4 < b.cap ? b.data[i0 + 4] : 0;
}

// The tool's 9-bit code of lane l (bit 0 of nib: its match bit): 0 at a
// match, else (l + 1) * 2 + (l & 1).
__device__ __forceinline__ uint32_t code_of(uint32_t nib, int l) {
  return (nib & 1u) ? 0u : (uint32_t)((l + 1) * 2 + (l & 1));
}

// One SWAR max step of the tool: s = (s & k) | (c & ~k).
__device__ __forceinline__ uint32_t swar_step(uint32_t s, uint32_t c) {
  const uint32_t guard = 0x80008000u;
  uint32_t g = ((s | guard) - c) & guard;
  uint32_t k = (g - (uint32_t)((int)g >> 15)) | g;
  return (s & k) | (c & ~k);
}

template <bool kSwar>
__global__ void __launch_bounds__(kThreads)
    block_scan(Batch b, int rpb, uint16_t* __restrict__ slots,
               int* __restrict__ carry_out, int* __restrict__ blk_last) {
  extern __shared__ uint32_t smem[];
  uint32_t* mbits = smem;              // rpb x 4 words: match bits
  uint32_t* sbits = smem + 4 * rpb;    // rpb x 4 words: start bits
  int* excl = (int*)(smem + 8 * rpb);  // rpb: last non-match of the rows before
  __shared__ int warp_tot[kWarps];
  int lane = threadIdx.x & 31;
  int warp = threadIdx.x >> 5;
  int base = blockIdx.x * rpb * 128;

  // 1. match bits and each row's last non-match position (kNeg if none)
  for (int j = warp; j < rpb; j += kWarps) {
    int i0 = base + j * 128 + 4 * lane;
    int d[4], after;
    load4(b, i0, lane, d, after);
    uint32_t nib = 0;
    int lnm = kNeg;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      int v;
      bool m = pair_at<true>(b, i0 + q, d[q], q < 3 ? d[q + 1] : after, v);
      nib |= (uint32_t)m << q;
      if (!m) lnm = i0 + q;
    }
    put_nibbles(mbits + 4 * j, nib, lane);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) lnm = max(lnm, __shfl_xor_sync(kFull, lnm, o));
    if (lane == 0) excl[j] = lnm;
  }
  __syncthreads();

  // 2. exclusive max over the rows of this block (kNeg for row 0)
  int per = (rpb + kThreads - 1) / kThreads;
  int lo = min(rpb, (int)threadIdx.x * per);
  int hi = min(rpb, lo + per);
  int local = kNeg;
  for (int j = lo; j < hi; ++j) local = max(local, excl[j]);
  int run = block_excl_max<kThreads>(local, warp_tot);
  for (int j = lo; j < hi; ++j) {
    int row_last = excl[j];
    excl[j] = run;
    run = max(run, row_last);
  }
  __syncthreads();

  // 3. start bits; a position's parity is its lane's (rows and blocks
  // start at even positions), and kNeg counts as odd
  int half = rpb / 2;
  for (int j = warp; j < rpb; j += kWarps) {
    uint32_t nib = get_nibble(mbits + 4 * j, lane);
    int row_par = excl[j] & 1;
    int par[4];
    if (!kSwar) {
      // the last non-match lane at or before each of the 4, within the row
      int last = -1, lastq[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (!((nib >> q) & 1u)) last = 4 * lane + q;
        lastq[q] = last;
      }
      int incl = last;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        int y = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl = max(incl, y);
      }
      int before = __shfl_up_sync(kFull, incl, 1);
      if (lane == 0) before = -1;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        int lz = max(before, lastq[q]);
        par[q] = lz >= 0 ? (lz & 1) : row_par;
      }
    } else {
      int pr = j < half ? j : j - half;
      uint32_t me = get_nibble(mbits + 4 * (2 * pr), lane);
      uint32_t mo = get_nibble(mbits + 4 * (2 * pr + 1), lane);
      uint32_t s[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        int l = 4 * lane + q;
        s[q] = (code_of(me >> q, l) & 0x7FFFu) | (code_of(mo >> q, l) << 16);
      }
#pragma unroll
      for (int sh = 1; sh < 128; sh <<= 1) {
        uint32_t c[4];
        if (sh == 1) {
          uint32_t up = __shfl_up_sync(kFull, s[3], 1);
          c[0] = lane >= 1 ? up : 0u;
          c[1] = s[0];
          c[2] = s[1];
          c[3] = s[2];
        } else if (sh == 2) {
          uint32_t up2 = __shfl_up_sync(kFull, s[2], 1);
          uint32_t up3 = __shfl_up_sync(kFull, s[3], 1);
          c[0] = lane >= 1 ? up2 : 0u;
          c[1] = lane >= 1 ? up3 : 0u;
          c[2] = s[0];
          c[3] = s[1];
        } else {
          int o = sh / 4;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            uint32_t up = __shfl_up_sync(kFull, s[q], o);
            c[q] = lane >= o ? up : 0u;
          }
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) s[q] = swar_step(s[q], c[q]);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        int f = (int)((j < half ? s[q] : s[q] >> 16) & 0xFFFFu);
        par[q] = f > 0 ? (f & 1) : row_par;
      }
    }
    uint32_t st = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (((nib >> q) & 1u) && (((4 * lane + q) & 1) ^ par[q])) st |= 1u << q;
    }
    put_nibbles(sbits + 4 * j, st, lane);
  }
  __syncthreads();

  // 4. slots; consumed at the block's first position waits for block_fixup
  for (int j = warp; j < rpb; j += kWarps) {
    int i0 = base + j * 128 + 4 * lane;
    uint32_t st = get_nibble(sbits + 4 * j, lane);
    uint32_t prev = (__shfl_up_sync(kFull, st, 1) >> 3) & 1u;
    if (lane == 0) prev = j > 0 ? sbits[4 * (j - 1) + 3] >> 31 : 0u;
    uint32_t consumed = (st << 1) | prev;
    int d[4], after;
    load4(b, i0, lane, d, after);
    uint32_t s[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      int v;
      pair_at<true>(b, i0 + q, d[q], q < 3 ? d[q + 1] : after, v);
      s[q] = ((consumed >> q) & 1u) ? 0u
             : ((st >> q) & 1u)     ? (uint32_t)v & 0xFFFFu
                                    : (uint32_t)d[q] << 8;
    }
    *reinterpret_cast<uint2*>(slots + i0) =
        make_uint2(s[0] | (s[1] << 16), s[2] | (s[3] << 16));
    int last = b.n - 1;
    if (last >= i0 && last < i0 + 4) carry_out[0] = (st >> (last - i0)) & 1u;
  }
  if (threadIdx.x == 0) blk_last[blockIdx.x] = sbits[4 * (rpb - 1) + 3] >> 31;
}

// consumed at each block's first position: the previous block's last start,
// or carry_in for block 0; and carry_out = carry_in when n == 0.
__global__ void block_fixup(uint16_t* __restrict__ slots,
                            const int* __restrict__ blk_last, int nb,
                            int block_positions, const int* __restrict__ carry_in,
                            int n, int* __restrict__ carry_out) {
  int bi = blockIdx.x * blockDim.x + threadIdx.x;
  if (bi < nb && (bi == 0 ? carry_in[0] != 0 : blk_last[bi - 1] != 0)) {
    slots[bi * block_positions] = 0;
  }
  if (bi == 0 && n == 0) carry_out[0] = carry_in[0];
}

template <bool kSwar>
int launch_block_scan(const Batch& b, int rpb, const int* carry_in,
                      uint16_t* slots, int* carry_out, int* blk_last,
                      cudaStream_t s) {
  int block_positions = rpb * 128;
  int nb = b.cap / block_positions;
  size_t smem = (size_t)rpb * 9 * sizeof(uint32_t);
  block_scan<kSwar><<<nb, kThreads, smem, s>>>(b, rpb, slots, carry_out, blk_last);
  int err = (int)cudaGetLastError();
  if (err) return err;
  block_fixup<<<(nb + 255) / 256, 256, 0, s>>>(slots, blk_last, nb, block_positions,
                                                carry_in, b.n, carry_out);
  return (int)cudaGetLastError();
}

// --- T10 noscan2 ---------------------------------------------------------

// The block's carry out for carry in 0 (bit 0) and for 1 (bit 1): its start
// at last_pos = min(block end, n - 1), which depends on the carry only
// through the sentinel, when last_pos's row matches up to it. A block with
// no position below n passes its carry through. One warp per block.
__global__ void __launch_bounds__(32)
    row_carry_map(Batch b, int rpb, int* __restrict__ map) {
  int lane = threadIdx.x;
  int start = blockIdx.x * rpb * 128;
  int last_pos = min(start + rpb * 128 - 1, b.n - 1);
  if (last_pos < start) {
    if (lane == 0) map[blockIdx.x] = 2;  // 0 -> 0, 1 -> 1
    return;
  }
  int i0 = (last_pos & ~127) + 4 * lane;
  int d[4], after;
  load4(b, i0, lane, d, after);
  int lnm = kNeg;
  bool m_last = false;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    int v;
    bool m = pair_at<true>(b, i0 + q, d[q], q < 3 ? d[q + 1] : after, v);
    if (i0 + q <= last_pos && !m) lnm = i0 + q;
    if (i0 + q == last_pos) m_last = m;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) lnm = max(lnm, __shfl_xor_sync(kFull, lnm, o));
  m_last = __any_sync(kFull, m_last);
  if (lane == 0) {
    int out = 0;
    for (int c = 0; c < 2; ++c) {
      int lz = max(lnm, start - 1 - c);
      out |= (int)(m_last && ((last_pos - lz) & 1)) << c;
    }
    map[blockIdx.x] = out;
  }
}

// carries[j] = block j's carry in, from carry_in through each block's map;
// carry_out = the last block's carry out.
__global__ void walk_carries(const int* __restrict__ map, int nb,
                             const int* __restrict__ carry_in,
                             int* __restrict__ carries,
                             int* __restrict__ carry_out) {
  int c = carry_in[0] != 0;
#pragma unroll 8
  for (int j = 0; j < nb; ++j) {
    carries[j] = c;
    c = (__ldg(map + j) >> c) & 1;
  }
  carry_out[0] = c;
}

__global__ void __launch_bounds__(kThreads)
    row_scan_emit(Batch b, int rpb, const int* __restrict__ carries,
                  uint16_t* __restrict__ slots) {
  extern __shared__ uint32_t sbits[];  // rpb x 4 words: start bits
  int lane = threadIdx.x & 31;
  int warp = threadIdx.x >> 5;
  int base = blockIdx.x * rpb * 128;
  int carry = carries[blockIdx.x];
  int sentinel = base - 1 - carry;

  // 1. start bits, from the scan within each row
  for (int j = warp; j < rpb; j += kWarps) {
    int i0 = base + j * 128 + 4 * lane;
    int d[4], after;
    load4(b, i0, lane, d, after);
    uint32_t nib = 0;
    int last = kNeg, lastq[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      int v;
      bool m = pair_at<true>(b, i0 + q, d[q], q < 3 ? d[q + 1] : after, v);
      nib |= (uint32_t)m << q;
      if (!m) last = i0 + q;
      lastq[q] = last;
    }
    int incl = last;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      int y = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl = max(incl, y);
    }
    int before = __shfl_up_sync(kFull, incl, 1);
    if (lane == 0) before = kNeg;
    uint32_t st = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      int lz = max(max(before, lastq[q]), sentinel);
      if (((nib >> q) & 1u) && ((i0 + q - lz) & 1)) st |= 1u << q;
    }
    put_nibbles(sbits + 4 * j, st, lane);
  }
  __syncthreads();

  // 2. slots; consumed at the block's first position is its carry
  for (int j = warp; j < rpb; j += kWarps) {
    int i0 = base + j * 128 + 4 * lane;
    uint32_t st = get_nibble(sbits + 4 * j, lane);
    uint32_t prev = (__shfl_up_sync(kFull, st, 1) >> 3) & 1u;
    if (lane == 0) prev = j > 0 ? sbits[4 * (j - 1) + 3] >> 31 : (uint32_t)carry;
    uint32_t consumed = (st << 1) | prev;
    int d[4], after;
    load4(b, i0, lane, d, after);
    uint32_t s[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      int v;
      pair_at<true>(b, i0 + q, d[q], q < 3 ? d[q + 1] : after, v);
      s[q] = ((consumed >> q) & 1u) ? 0u
             : ((st >> q) & 1u)     ? (uint32_t)v & 0xFFFFu
                                    : (uint32_t)d[q] << 8;
    }
    *reinterpret_cast<uint2*>(slots + i0) =
        make_uint2(s[0] | (s[1] << 16), s[2] | (s[3] << 16));
  }
}

int launch_row_scan(const Batch& b, int rpb, const int* carry_in,
                    uint16_t* slots, int* carry_out, int* scratch,
                    cudaStream_t s) {
  int nb = b.cap / (rpb * 128);
  int* map = scratch;
  int* carries = scratch + nb;
  row_carry_map<<<nb, 32, 0, s>>>(b, rpb, map);
  int err = (int)cudaGetLastError();
  if (err) return err;
  walk_carries<<<1, 1, 0, s>>>(map, nb, carry_in, carries, carry_out);
  err = (int)cudaGetLastError();
  if (err) return err;
  row_scan_emit<<<nb, kThreads, (size_t)rpb * 4 * sizeof(uint32_t), s>>>(
      b, rpb, carries, slots);
  return (int)cudaGetLastError();
}

// --- T12: the block-local parity scan of a mask ---------------------------

// Each of a thread's 4 lanes' last zero lane at or before it within the
// row, -1 if none (nib: bit q is lane 4 * lane + q's match bit).
template <bool kBf16>
__device__ __forceinline__ void lane_scan(uint32_t nib, int lane, int lz[4]);

template <>
__device__ __forceinline__ void lane_scan<false>(uint32_t nib, int lane, int lz[4]) {
  int last = -1;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if (!((nib >> q) & 1u)) last = 4 * lane + q;
    lz[q] = last;
  }
  int incl = last;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    int y = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl = max(incl, y);
  }
  int before = __shfl_up_sync(kFull, incl, 1);
  if (lane == 0) before = -1;
#pragma unroll
  for (int q = 0; q < 4; ++q) lz[q] = max(lz[q], before);
}

template <>
__device__ __forceinline__ void lane_scan<true>(uint32_t nib, int lane, int lz[4]) {
  const __nv_bfloat16 none = __int2bfloat16_rn(-1);
  __nv_bfloat16 v[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    v[q] = ((nib >> q) & 1u) ? none : __int2bfloat16_rn(4 * lane + q);
  }
  // lanes (0, 1) and (2, 3) in one register each, scanned inside the pair,
  // then the pair (2, 3) after the pair (0, 1)
  __nv_bfloat162 lo = __halves2bfloat162(v[0], v[1]);
  __nv_bfloat162 hi = __halves2bfloat162(v[2], v[3]);
  lo = __hmax2(lo, __halves2bfloat162(none, __low2bfloat16(lo)));
  hi = __hmax2(hi, __halves2bfloat162(none, __low2bfloat16(hi)));
  hi = __hmax2(hi, __bfloat162bfloat162(__high2bfloat16(lo)));
  // the warp's inclusive scan of each thread's maximum, both halves alike
  __nv_bfloat162 incl = __bfloat162bfloat162(__high2bfloat16(hi));
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    __nv_bfloat162 y = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl = __hmax2(incl, y);
  }
  __nv_bfloat162 before = __shfl_up_sync(kFull, incl, 1);
  if (lane == 0) before = __bfloat162bfloat162(none);
  lo = __hmax2(lo, before);
  hi = __hmax2(hi, before);
  lz[0] = __bfloat162int_rz(__low2bfloat16(lo));
  lz[1] = __bfloat162int_rz(__high2bfloat16(lo));
  lz[2] = __bfloat162int_rz(__low2bfloat16(hi));
  lz[3] = __bfloat162int_rz(__high2bfloat16(hi));
}

template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
    mask_scan(const uint8_t* __restrict__ mask, uint8_t* __restrict__ out,
              int rpb) {
  extern __shared__ uint32_t smem[];
  uint32_t* mbits = smem;            // rpb x 4 words: match bits
  int* excl = (int*)(smem + 4 * rpb);  // rpb: last zero of the rows before
  __shared__ int warp_tot[kWarps];
  int lane = threadIdx.x & 31;
  int warp = threadIdx.x >> 5;
  size_t base = (size_t)blockIdx.x * rpb * 128;

  // 1. match bits and each row's last zero (block-local index, kNeg if none)
  for (int j = warp; j < rpb; j += kWarps) {
    uint32_t w = *reinterpret_cast<const uint32_t*>(mask + base + j * 128 + 4 * lane);
    uint32_t nib = 0;
    int lnm = kNeg;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      bool m = ((w >> (8 * q)) & 0xFFu) != 0;
      nib |= (uint32_t)m << q;
      if (!m) lnm = j * 128 + 4 * lane + q;
    }
    put_nibbles(mbits + 4 * j, nib, lane);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) lnm = max(lnm, __shfl_xor_sync(kFull, lnm, o));
    if (lane == 0) excl[j] = lnm;
  }
  __syncthreads();

  // 2. exclusive max over the rows of this block (kNeg for row 0)
  int per = (rpb + kThreads - 1) / kThreads;
  int lo = min(rpb, (int)threadIdx.x * per);
  int hi = min(rpb, lo + per);
  int local = kNeg;
  for (int j = lo; j < hi; ++j) local = max(local, excl[j]);
  int run = block_excl_max<kThreads>(local, warp_tot);
  for (int j = lo; j < hi; ++j) {
    int row_last = excl[j];
    excl[j] = run;
    run = max(run, row_last);
  }
  __syncthreads();

  // 3. starts; rows start at even positions, so a position's parity is its
  // lane's, and "none" (lz = -1) is odd
  for (int j = warp; j < rpb; j += kWarps) {
    uint32_t nib = get_nibble(mbits + 4 * j, lane);
    int row_par = excl[j] == kNeg ? 1 : (excl[j] & 1);
    int lz[4];
    lane_scan<kBf16>(nib, lane, lz);
    uint32_t w = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      int par = lz[q] >= 0 ? (lz[q] & 1) : row_par;
      if (((nib >> q) & 1u) && ((q & 1) ^ par)) w |= 1u << (8 * q);
    }
    *reinterpret_cast<uint32_t*>(out + base + j * 128 + 4 * lane) = w;
  }
}

}  // namespace

// swar: 0 scan16, 1 swarpack. Arguments as blt_flat_pass (flat_bpe.cu),
// plus rpb, the Pallas block's rows (a multiple of 8 up to 1024, cap a
// multiple of rpb * 128, checked by the wrapper); scratch: cap / (rpb * 128)
// int32. Returns the first nonzero cudaGetLastError() of the launches.
extern "C" int blt_block_scan(int swar, const void* data, int cap, int n,
                              int next_byte, const void* table,
                              const void* carry_in, void* slots,
                              void* carry_out, void* scratch, int rpb,
                              void* stream) {
  Batch b{(const uint8_t*)data, (const uint16_t*)table, cap, n, next_byte};
  auto launch = swar ? launch_block_scan<true> : launch_block_scan<false>;
  return launch(b, rpb, (const int*)carry_in, (uint16_t*)slots, (int*)carry_out,
                (int*)scratch, (cudaStream_t)stream);
}

// noscan2 (T10): arguments as blt_block_scan, scratch 2 * cap / (rpb * 128)
// int32. Returns the first nonzero cudaGetLastError() of the launches.
extern "C" int blt_row_scan(const void* data, int cap, int n, int next_byte,
                            const void* table, const void* carry_in,
                            void* slots, void* carry_out, void* scratch,
                            int rpb, void* stream) {
  Batch b{(const uint8_t*)data, (const uint16_t*)table, cap, n, next_byte};
  return launch_row_scan(b, rpb, (const int*)carry_in, (uint16_t*)slots,
                         (int*)carry_out, (int*)scratch, (cudaStream_t)stream);
}

// T12: bf16 0 for the int32 scan, 1 for the bf16x2 one. mask, out: rows x
// 128 bytes (4-byte aligned), rows a multiple of rpb (a multiple of 8 up to
// 1024, checked by the wrapper). Returns cudaGetLastError().
extern "C" int blt_mask_scan(int bf16, const void* mask, void* out, int rows,
                             int rpb, void* stream) {
  auto kernel = bf16 ? mask_scan<true> : mask_scan<false>;
  kernel<<<rows / rpb, kThreads, (size_t)rpb * 5 * sizeof(uint32_t),
           (cudaStream_t)stream>>>((const uint8_t*)mask, (uint8_t*)out, rpb);
  return (int)cudaGetLastError();
}
