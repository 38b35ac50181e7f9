// The integer op-mix probe in int32, int16 and int8, launched k times back to
// back through a token (T5).
//
// Replaces: tools/exp_pack.py::chain.call (kernel body _mix_kernel(dtype)).
//
// Per element of a (rows, 128) tensor x of type T, 8 repetitions of (the
// function of _mix_kernel, every op wrapping in T as jnp does):
//   y = (acc * 31) >> 3 & 0x3F       (arithmetic shift)
//   r = acc at lane (l - 1) mod 128 of the same row   (pltpu.roll by 1)
//   y = y == (acc & 0x3F) ? r : y
//   acc = (lane >= 2 ? max(y, acc) : y) + 1
// starting from acc = x; out = acc. The token is what the Pallas grid's last
// step writes, tok_in + rows / rpb - 1; the wrapper passes that addend. Each
// launch reads the same x, so only the token chains.
//
// Bound on the H100: the larger of the bytes and the operations. The
// function needs 8 integer operations per element per repetition (mul,
// shift, and, and, compare, select, max, add), 64 per element; the roll is a
// move of data, and the lane >= 2 test and its select are the same in every
// repetition and only lanes 0 and 1 take the select, so none is counted.
// int32 computes one element a 32-bit lane: at 2 Mi elements about 4.0 us at
// 132 SMs x 128 lanes issued per clock x 1.98 GHz, under its 5.0 us of bytes
// (4 read and 4 written per element), so int32 is bound by its bytes. int16
// and int8 carry two and four elements a 32-bit register, so their
// operations take 2.0 and 1.0 us in 32-bit lane operations, under their
// bytes' 2.5 and 1.3 us: both are bound by their bytes too. x and out stay
// in the 50 MB L2 across a chain, so what holds a launch back is the issue
// rate of the integer pipes and the gap between launches.
//
// Design. int32: one warp per row, each thread owning 4 consecutive lanes
// (one 16-byte load and store), so the roll is a register move plus one
// warp shuffle per repetition; a grid-stride loop over the rows, the grid
// sized to the card.
//
// int16 and int8 (op_mix_packed_kernel): each thread owns one 16-byte
// vector of its row, four 32-bit words of two halfwords or four bytes, so
// a row is 16 (int16) or 8 (int8) threads and the roll's one shuffle a
// repetition takes __shfl_sync's width. Every step works on whole words:
// - y: ((acc * 31) >> 3) & 0x3F depends only on acc mod 512 per halfword
//   (bits 3..8 of the product), and 511 * 31 < 2^16, so one multiply of the
//   masked word serves both halves. An int8 y is bits 3..7 of the product
//   byte with bit 7 copied to bit 5 (the arithmetic shift's sign): the even
//   and the odd bytes, spread into halfwords, are multiplied by 31 * 32,
//   which lands each product's bits 3..7 at the bottom of a byte; a prmt
//   gathers the four fields and a multiply-add copies bit 4 to bit 5.
// - the select: y ^ (acc & 0x3F) plus 0x7FFF (0x7F) a lane sets each lane's
//   top bit where the two differ; prmt's sign-replicating selectors spread
//   it to a lane mask, and the select is one bitwise blend.
// - the roll: a prmt of the word before and this word; the first word takes
//   the last word of the thread before, cyclically within the row.
// - max: the signed halfword max sm_90 added (max.s16x2, SASS VIMNMX.S16x2).
//   int8 has no packed byte max; a halfword max orders halfwords by their
//   high byte first, so the odd bytes take the max of the words as they
//   are and the even bytes the max of the words shifted up by 8 (an
//   IMAD.SHL each), and a prmt joins the two: 5 instructions for four
//   bytes, where sign-extending every byte into halfwords takes 7 and a
//   SWAR compare and blend more.
// - + 1: the halfword add sm_90 added (add.s16x2, SASS VIADD.16x2: one
//   instruction where the carry-free SWAR add takes three). int8 adds 0x100
//   to each halfword of both maxes before the join, so each byte's carry
//   leaves through its halfword's top.
// - lanes 0 and 1 take y: the first thread's first word enters the max with
//   those lanes set to the type's minimum.
// No lane is ever widened to 32 bits or sign-extended after an op.
// SASS (cuobjdump, NVIDIA H100 build): about 11.5 instructions a word and
// repetition for int16 (5.7 an element: LOP3 3.8, VIADD 1.9, PRMT 1.9,
// IMAD 1.4, SHF 1, VIMNMX 0.9) and 20 for int8 (5 an element: PRMT 5.5,
// IMAD 5.2, LOP3 4.2, VIADD 2.8, VIMNMX 1.9), against 8.8 an element for
// int32; 27 and 28 registers, no spill, 8 CTAs an SM. About 10 and 14 of
// them a word go to the integer ALU pipe, 64 lanes a clock an SM, which
// bounds the time: an IMAD.HI for int16's shift, a multiply-add for the
// select's test and two words a thread all ran slower or no faster.
//
// As chain.cu, one thread writes the token once and a chain alternates two
// token buffers.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kReps = 8;  // OPS_REPS

__global__ void __launch_bounds__(kThreads)
    op_mix_kernel(const int4* __restrict__ x, int4* __restrict__ out, int rows,
                  const int* __restrict__ tok_in, int* __restrict__ tok_out, int add) {
  int lane = threadIdx.x & 31;
  int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  int warps = (gridDim.x * blockDim.x) >> 5;
  for (int row = warp; row < rows; row += warps) {
    int4 v = x[row * 32 + lane];
    int acc[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int rep = 0; rep < kReps; ++rep) {
      int from_left = __shfl_sync(0xffffffffu, acc[3], (lane + 31) & 31);
      int next[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        int l = 4 * lane + q;
        int y = ((int)((uint32_t)acc[q] * 31u) >> 3) & 0x3F;
        int r = q ? acc[q - 1] : from_left;
        if (y == (acc[q] & 0x3F)) y = r;
        int z = max(y, acc[q]);
        next[q] = (int)((uint32_t)(l >= 2 ? z : y) + 1u);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[q] = next[q];
    }
    out[row * 32 + lane] = make_int4(acc[0], acc[1], acc[2], acc[3]);
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) tok_out[0] = tok_in[0] + add;
}

__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t sel) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(sel));
  return d;
}

__device__ __forceinline__ uint32_t max_s16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("max.s16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// Each halfword plus b's, wrapping (no carry crosses a half).
__device__ __forceinline__ uint32_t add_16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("add.s16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// One repetition of the mix on a word of two halfwords. w: the word, prev:
// the word before it in the row, m: w as the max sees it.
struct Mix16 {
  static constexpr int kRowThreads = 16;        // 128 lanes x 2 bytes / 16
  static constexpr uint32_t kMod512 = 0x01FF01FFu;
  static constexpr uint32_t kLow6 = 0x003F003Fu;
  static constexpr uint32_t kDiffBias = 0x7FFF7FFFu;  // sets bit 15 where a half is not 0
  static constexpr uint32_t kSpreadSel = 0xBB99u;     // bytes 1 and 3's signs over their halves
  static constexpr uint32_t kRollSel = 0x5432u;       // prev's high half, w's low half
  static constexpr uint32_t kOne = 0x00010001u;
  static constexpr uint32_t kFirstKeep = 0x00000000u;  // lanes 0 and 1 ...
  static constexpr uint32_t kFirstMin = 0x80008000u;   // ... enter the max at -32768

  __device__ __forceinline__ static uint32_t step(uint32_t w, uint32_t prev, uint32_t m) {
    uint32_t y = ((w & kMod512) * 31u >> 3) & kLow6;
    uint32_t differ = prmt((y ^ (w & kLow6)) + kDiffBias, 0u, kSpreadSel);
    uint32_t s = (y & differ) | (prmt(prev, w, kRollSel) & ~differ);
    return add_16x2(max_s16x2(s, m), kOne);
  }
};

// The same on a word of four bytes.
struct Mix8 {
  static constexpr int kRowThreads = 8;         // 128 lanes x 1 byte / 16
  static constexpr uint32_t kEven = 0x00FF00FFu;
  static constexpr uint32_t kOddSel = 0x4341u;        // bytes 1 and 3 down to 0 and 2
  static constexpr uint32_t kMul = 31u * 32u;         // bits 3..7 of p to bits 8..12
  static constexpr uint32_t kFieldSel = 0x7351u;      // bytes 1 and 3 of the even, the odd
  static constexpr uint32_t kLow5 = 0x1F1F1F1Fu;
  static constexpr uint32_t kBit4 = 0x10101010u;
  static constexpr uint32_t kLow6 = 0x3F3F3F3Fu;
  static constexpr uint32_t kDiffBias = 0x7F7F7F7Fu;  // sets bit 7 where a byte is not 0
  static constexpr uint32_t kSpreadSel = 0xBA98u;     // each byte's sign over it
  static constexpr uint32_t kRollSel = 0x6543u;       // prev's byte 3, w's bytes 0..2
  static constexpr uint32_t kJoinSel = 0x7351u;       // even max, odd max, even, odd
  static constexpr uint32_t kOne = 0x01000100u;       // + 1 to each halfword's high byte
  static constexpr uint32_t kFirstKeep = 0xFFFF0000u;  // lanes 0 and 1 ...
  static constexpr uint32_t kFirstMin = 0x00008080u;   // ... enter the max at -128

  __device__ __forceinline__ static uint32_t step(uint32_t w, uint32_t prev, uint32_t m) {
    uint32_t f = prmt((w & kEven) * kMul, prmt(w, 0u, kOddSel) * kMul, kFieldSel);
    uint32_t y = (f & kLow5) + 2u * (f & kBit4);
    uint32_t differ = prmt(((y ^ w) & kLow6) + kDiffBias, 0u, kSpreadSel);
    uint32_t s = (y & differ) | (prmt(prev, w, kRollSel) & ~differ);
    return prmt(add_16x2(max_s16x2(s << 8, m << 8), kOne), add_16x2(max_s16x2(s, m), kOne),
                kJoinSel);
  }
};

template <typename M>
__global__ void __launch_bounds__(kThreads)
    op_mix_packed_kernel(const uint4* __restrict__ x, uint4* __restrict__ out, int rows,
                         const int* __restrict__ tok_in, int* __restrict__ tok_out, int add) {
  constexpr int kTpr = M::kRowThreads;
  constexpr int kRowsPerWarp = 32 / kTpr;
  int lane = threadIdx.x & 31;
  int part = lane % kTpr;  // this thread's vector of its row
  int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  int warps = (gridDim.x * blockDim.x) >> 5;
  uint32_t keep = part ? ~0u : M::kFirstKeep;
  uint32_t low = part ? 0u : M::kFirstMin;
  // whole warps take each step, so the shuffles always see 32 threads
  for (int base = warp * kRowsPerWarp; base < rows; base += warps * kRowsPerWarp) {
    int row = base + lane / kTpr;
    bool live = row < rows;
    uint4 v = live ? x[(size_t)row * kTpr + part] : make_uint4(0, 0, 0, 0);
    uint32_t acc[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int rep = 0; rep < kReps; ++rep) {
      uint32_t prev = __shfl_sync(0xffffffffu, acc[3], part + kTpr - 1, kTpr);
      uint32_t next[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        next[j] = M::step(acc[j], prev, j ? acc[j] : (acc[0] & keep) | low);
        prev = acc[j];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[j] = next[j];
    }
    if (live) out[(size_t)row * kTpr + part] = make_uint4(acc[0], acc[1], acc[2], acc[3]);
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) tok_out[0] = tok_in[0] + add;
}

template <typename V, typename K>
int launch_chain(K kernel, int threads, const void* x, void* out, int rows, const void* tok_in,
                 void* tok_a, void* tok_b, int add, int k, cudaStream_t s) {
  int want = (int)(((int64_t)threads + kThreads - 1) / kThreads);
  int blocks = want < 132 * 16 ? want : 132 * 16;
  const int* in = (const int*)tok_in;
  for (int j = 0; j < k; ++j) {
    int* tok = (int*)((j & 1) ? tok_b : tok_a);
    kernel<<<blocks, kThreads, 0, s>>>((const V*)x, (V*)out, rows, in, tok, add);
    int err = (int)cudaGetLastError();
    if (err) return err;
    in = tok;
  }
  return 0;
}

template <typename M>
int packed_ctas(int* ctas) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, op_mix_packed_kernel<M>,
                                                            kThreads, 0);
}

}  // namespace

// bytes: 4 (int32), 2 (int16) or 1 (int8). x, out: rows x 128 elements
// (16-byte aligned, checked by the wrapper); tok_in: one int32;
// tok_a, tok_b: one int32 each. Launch j reads tok_in (j = 0) or the token
// launch j - 1 wrote, and writes tok_a (j even) or tok_b (j odd). Returns
// the first nonzero cudaGetLastError() of the launches, or
// cudaErrorInvalidValue for another width.
extern "C" int blt_op_mix(int bytes, const void* x, void* out, int rows,
                          const void* tok_in, void* tok_a, void* tok_b, int add,
                          int k, void* stream) {
  if (rows <= 0 || k <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (bytes) {
    case 4:
      return launch_chain<int4>(op_mix_kernel, rows * 32, x, out, rows, tok_in, tok_a, tok_b,
                                add, k, s);
    case 2:
      return launch_chain<uint4>(op_mix_packed_kernel<Mix16>, rows * Mix16::kRowThreads, x, out,
                                 rows, tok_in, tok_a, tok_b, add, k, s);
    case 1:
      return launch_chain<uint4>(op_mix_packed_kernel<Mix8>, rows * Mix8::kRowThreads, x, out,
                                 rows, tok_in, tok_a, tok_b, add, k, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// CTAs per SM of the int16 and int8 kernels on the current device, as the
// CUDA runtime computes them.
extern "C" int blt_op_mix16_ctas_per_sm(int* ctas) { return packed_ctas<Mix16>(ctas); }
extern "C" int blt_op_mix8_ctas_per_sm(int* ctas) { return packed_ctas<Mix8>(ctas); }
