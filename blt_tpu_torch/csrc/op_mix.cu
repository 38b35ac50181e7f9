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
// repetition and only lanes 0 and 1 take the select, so none is counted. At
// 2 Mi elements that is about 4.0 us at 132 SMs x 128 lanes issued per clock
// x 1.98 GHz, against 5.0 us for the int32 bytes (4 read and 4 written per
// element), 2.5 us for int16 and 1.3 us for int8: int32 is bound by its
// bytes, int16 and int8 by the operations. The narrow types compute in
// 32-bit registers.
//
// Design: one warp per row, each thread owning 4 consecutive lanes (one 16-,
// 8- or 4-byte load and store), so the roll is a register move plus one
// warp shuffle per repetition; a grid-stride loop over the rows, the grid
// sized to the card. As chain.cu, one thread writes the token once and a
// chain alternates two token buffers.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kReps = 8;  // OPS_REPS

template <typename T> struct Vec4;
template <> struct Vec4<int32_t> { using type = int4; };
template <> struct Vec4<int16_t> { using type = short4; };
template <> struct Vec4<int8_t> { using type = char4; };

// One value wrapped to T, as a 32-bit int (sign-extended).
template <typename T>
__device__ __forceinline__ int wrap(int v) {
  return (int)(T)v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    op_mix_kernel(const typename Vec4<T>::type* __restrict__ x,
                  typename Vec4<T>::type* __restrict__ out, int rows,
                  const int* __restrict__ tok_in, int* __restrict__ tok_out,
                  int add) {
  using V = typename Vec4<T>::type;
  int lane = threadIdx.x & 31;
  int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  int warps = (gridDim.x * blockDim.x) >> 5;
  for (int row = warp; row < rows; row += warps) {
    V v = x[row * 32 + lane];
    int acc[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int rep = 0; rep < kReps; ++rep) {
      int from_left = __shfl_sync(0xffffffffu, acc[3], (lane + 31) & 31);
      int next[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        int l = 4 * lane + q;
        int y = wrap<T>((int)((uint32_t)acc[q] * 31u));
        y = wrap<T>(y >> 3);
        y &= 0x3F;
        int r = q ? acc[q - 1] : from_left;
        if (y == (acc[q] & 0x3F)) y = r;
        int z = max(y, acc[q]);
        next[q] = wrap<T>((int)((uint32_t)(l >= 2 ? z : y) + 1u));
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[q] = next[q];
    }
    V o;
    o.x = (T)acc[0];
    o.y = (T)acc[1];
    o.z = (T)acc[2];
    o.w = (T)acc[3];
    out[row * 32 + lane] = o;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) tok_out[0] = tok_in[0] + add;
}

template <typename T>
int launch_chain(const void* x, void* out, int rows, const void* tok_in,
                 void* tok_a, void* tok_b, int add, int k, cudaStream_t s) {
  using V = typename Vec4<T>::type;
  int want = (rows * 32 + kThreads - 1) / kThreads;
  int blocks = want < 132 * 16 ? want : 132 * 16;
  const int* in = (const int*)tok_in;
  for (int j = 0; j < k; ++j) {
    int* tok = (int*)((j & 1) ? tok_b : tok_a);
    op_mix_kernel<T><<<blocks, kThreads, 0, s>>>((const V*)x, (V*)out, rows, in,
                                                  tok, add);
    int err = (int)cudaGetLastError();
    if (err) return err;
    in = tok;
  }
  return 0;
}

}  // namespace

// bytes: 4 (int32), 2 (int16) or 1 (int8). x, out: rows x 128 elements
// (aligned to 4 elements, checked by the wrapper); tok_in: one int32;
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
    case 4: return launch_chain<int32_t>(x, out, rows, tok_in, tok_a, tok_b, add, k, s);
    case 2: return launch_chain<int16_t>(x, out, rows, tok_in, tok_a, tok_b, add, k, s);
    case 1: return launch_chain<int8_t>(x, out, rows, tok_in, tok_a, tok_b, add, k, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
