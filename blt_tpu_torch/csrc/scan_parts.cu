// The flat-BPE pass's ablation with the parity scan run block by block, in
// 16-bit or SWAR-packed form: T6's scan16 and swarpack.
//
// Replaces: tools/exp_scan.py::_pallas (kernel body _variant_body) for those
// two variants. T6's other four (full, noscan, nolookup, noshifts) are flag
// sets of the flat pass, blt_flat_pass (flat_bpe.cu).
//
// Each variant takes K2's arguments and the dense wire table in place of the
// tool's CHD probe (the same function: the pre-byteswapped rule value or no
// rule), emits values unswapped (as K2) and writes carry_out = start[n-1]
// (carry_in when n == 0):
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
// In both, consumed = start[i-1], or carry_in at i == 0, and the next byte
// of a block's last position is the next block's first byte.
//
// Bound on the H100: the bytes, as K2: 1 byte in and 2 bytes of slots out
// per position plus the 128 KB table (192 MiB at 64 MiB, about 60 us at
// 3.35 TB/s).
//
// Design: both are block-local, so one CUDA block of 256
// threads takes one Pallas block of rpb rows, a warp per row and 4 lanes per
// thread, in four steps with shared memory between them (36 bytes per row):
// the match bits and each row's last non-match, the exclusive max over the
// rows, the start bits, then the slots with 8-byte stores (the batch is read
// and looked up twice). A second launch applies consumed at each block's
// first position, which needs the previous block's last start (or
// carry_in).

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
