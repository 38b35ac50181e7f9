// 16-bit elementwise and shuffle probes: T3 and T11.
//
// Replaces: tools/exp_16bit.py (run, bodies k_bf16_roll, k_bf16_max,
// k_bf16_select, k_bf16_rowroll, k_i16_roll, k_bf16_scan) and
// tools/canary_16bit.py (_probe, bodies k_i16_roll and k_strided_sublane of
// run_canary). On the TPU each asked whether Mosaic lowers a 16-bit op; on
// the card each runs, and the question left is whether the kernel computes
// what its plain version does.
//
// Functions, x i32[rows, 128] -> i32[rows, 128] (strided_sublane: ->
// i32[ceil(rows / 2), 128]), b = bf16(x):
//   bf16_roll: roll(b, 1, lanes): lane l takes lane l - 1, lane 0 lane 127;
//   bf16_max: max(b, b * 0.5);
//   bf16_select: b at lanes >= 5, else -1;
//   bf16_rowroll: roll(b, 1, rows): row r takes row r - 1, row 0 the last;
//   i16_roll (T3's, and T11's under its own counter): roll(i16(x), 1, lanes);
//   bf16_scan7: the inclusive lane prefix max of ((x & 3) == 0 ? -1 : lane)
//     in bf16, seven roll-and-max steps;
//   strided_sublane: rows 0, 2, 4, ... of x.
// bf16(x) is int32 -> f32 (round to nearest) -> bf16 (round to nearest even),
// the two roundings XLA's and torch's casts make (a direct rounding differs
// from them where the first lands on a tie, such as 2**25 + 2**17 + 1); the
// way back truncates toward zero (__bfloat162int_rz). The values stay inside
// int32 for |x| < 2**30; past that XLA saturates and a torch cast does not.
// i16(x) keeps the low 16 bits.
//
// Each body computes in the 16-bit type the original names: __nv_bfloat16
// with the cuda_bf16.h intrinsics (__hmax, __hmul, conversions), short for
// i16; a roll moves 16-bit values through shared memory. One block per 8
// rows, a thread per element.
//
// Bound on the H100: the bytes, x read and the result written once (only
// the even rows read for strided_sublane): 128 MiB at 131072 rows, 0.040 ms
// at 3.35 TB/s; the originals' 512 and 8 rows are launch-bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

enum Probe : int {
  kBf16Roll = 0,
  kBf16Max = 1,
  kBf16Select = 2,
  kBf16RowRoll = 3,
  kI16Roll = 4,
  kBf16Scan7 = 5,
  kCanaryI16Roll = 6,
  kCanaryStrided = 7,
};

constexpr int kLanes = 128;
constexpr int kRowsPerBlock = 8;

__device__ __forceinline__ __nv_bfloat16 to_bf16(int v) {
  return __float2bfloat16_rn(__int2float_rn(v));
}

template <int P>
__global__ void __launch_bounds__(kLanes * kRowsPerBlock)
    probe16_kernel(const int* __restrict__ x, int* __restrict__ out, int rows) {
  __shared__ unsigned short sb[kRowsPerBlock + 1][kLanes];  // bf16 bits
  __shared__ short ss[kRowsPerBlock][kLanes];
  const int l = threadIdx.x;
  const int y = threadIdx.y;
  const int r = blockIdx.x * kRowsPerBlock + y;
  if constexpr (P == kCanaryStrided) {
    if (r < (rows + 1) / 2) out[(size_t)r * kLanes + l] = x[(size_t)2 * r * kLanes + l];
    return;
  }
  // rows past the end take part in every barrier and store nothing
  const bool valid = r < rows;
  const int v = valid ? x[(size_t)r * kLanes + l] : 0;
  int res = 0;
  if constexpr (P == kBf16Roll) {
    sb[y][l] = __bfloat16_as_ushort(to_bf16(v));
    __syncthreads();
    res = __bfloat162int_rz(__ushort_as_bfloat16(sb[y][(l + kLanes - 1) % kLanes]));
  } else if constexpr (P == kBf16Max) {
    __nv_bfloat16 b = to_bf16(v);
    res = __bfloat162int_rz(__hmax(b, __hmul(b, __float2bfloat16_rn(0.5f))));
  } else if constexpr (P == kBf16Select) {
    __nv_bfloat16 b = to_bf16(v);
    res = __bfloat162int_rz(l >= 5 ? b : __float2bfloat16_rn(-1.0f));
  } else if constexpr (P == kBf16RowRoll) {
    // sb[1 + y]: the block's rows; sb[0]: the row before them, wrapping
    sb[1 + y][l] = __bfloat16_as_ushort(to_bf16(v));
    if (y == 0) {
      int prev = (blockIdx.x * kRowsPerBlock + rows - 1) % rows;
      sb[0][l] = __bfloat16_as_ushort(to_bf16(x[(size_t)prev * kLanes + l]));
    }
    __syncthreads();
    res = __bfloat162int_rz(__ushort_as_bfloat16(sb[y][l]));
  } else if constexpr (P == kI16Roll || P == kCanaryI16Roll) {
    ss[y][l] = (short)v;
    __syncthreads();
    res = ss[y][(l + kLanes - 1) % kLanes];
  } else if constexpr (P == kBf16Scan7) {
    const __nv_bfloat16 neg1 = __float2bfloat16_rn(-1.0f);
    __nv_bfloat16 s = (v & 3) == 0 ? neg1 : __int2bfloat16_rn(l);
#pragma unroll
    for (int sh = 1; sh < kLanes; sh *= 2) {
      sb[y][l] = __bfloat16_as_ushort(s);
      __syncthreads();
      __nv_bfloat16 rolled = __ushort_as_bfloat16(sb[y][(l + kLanes - sh) % kLanes]);
      __syncthreads();
      s = __hmax(s, l >= sh ? rolled : neg1);
    }
    res = __bfloat162int_rz(s);
  }
  if (valid) out[(size_t)r * kLanes + l] = res;
}

template <int P>
int launch_probe16(const int* x, int* out, int rows, cudaStream_t s) {
  int out_rows = P == kCanaryStrided ? (rows + 1) / 2 : rows;
  int grid = (out_rows + kRowsPerBlock - 1) / kRowsPerBlock;
  probe16_kernel<P><<<grid, dim3(kLanes, kRowsPerBlock), 0, s>>>(x, out, rows);
  return (int)cudaGetLastError();
}

}  // namespace

// probe: 0..7 in tools_cuda.PROBES16's order. x: rows int32 rows of 128;
// out: rows rows (strided_sublane: ceil(rows / 2)); rows positive, rows *
// 128 below 2**31 (checked by the wrapper). Returns the launch's CUDA error,
// or cudaErrorInvalidValue for another probe or no rows.
extern "C" int blt_probe16(int probe, const void* x, void* out, int rows, void* stream) {
  if (rows <= 0) return (int)cudaErrorInvalidValue;
  auto xx = (const int*)x;
  auto o = (int*)out;
  auto s = (cudaStream_t)stream;
  switch (probe) {
    case kBf16Roll: return launch_probe16<kBf16Roll>(xx, o, rows, s);
    case kBf16Max: return launch_probe16<kBf16Max>(xx, o, rows, s);
    case kBf16Select: return launch_probe16<kBf16Select>(xx, o, rows, s);
    case kBf16RowRoll: return launch_probe16<kBf16RowRoll>(xx, o, rows, s);
    case kI16Roll: return launch_probe16<kI16Roll>(xx, o, rows, s);
    case kBf16Scan7: return launch_probe16<kBf16Scan7>(xx, o, rows, s);
    case kCanaryI16Roll: return launch_probe16<kCanaryI16Roll>(xx, o, rows, s);
    case kCanaryStrided: return launch_probe16<kCanaryStrided>(xx, o, rows, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
