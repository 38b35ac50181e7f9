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
// i16.
//
// Bound on the H100: the bytes, x read and the result written once (only
// the even rows read for strided_sublane): 128 MiB at 131072 rows, 0.040 ms
// at 3.35 TB/s; the originals' 512 and 8 rows are launch-bound.
//
// Design: a warp a row, each lane 4 consecutive int32 of it, loaded and
// stored as one 16-byte vector; a warp takes kRowsPerWarp rows and issues
// all their loads before it uses any, 256-thread CTAs of kRowsPerCta rows
// (4096 CTAs at 131072 rows). Where that grid would not give every SM
// kFillCtas CTAs, a warp takes one row and a CTA as few warps as spread the
// rows over the SMs (at 512 rows 128 CTAs of 4 warps, not 16 of 8 x 4
// rows): a small call is bound by each SM's conversions, not by bytes.
// No shared memory and no barrier:
//   lane rolls (bf16_roll, i16_roll): elements move inside the lane, and
//   element 0 takes element 3 of lane t - 1 by one __shfl_sync, which also
//   brings lane 127 to lane 0;
//   bf16_rowroll: the warp reads row r - 1 (the last row for row 0) and
//   writes row r, one read an element;
//   bf16_scan7: three __hmax steps inside the lane, an inclusive scan of
//   the lanes' maxima by __shfl_up_sync, and one __hmax with the lanes
//   before; exact on -1..127, so equal to the seven roll-and-max steps;
//   strided_sublane: a warp per output row r reads row 2r.
// Rows past the end are masked per warp: a warp's branch is uniform, so
// every shuffle runs with the whole warp.

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
constexpr int kThreads = 256;
constexpr int kRowsPerWarp = 4;
constexpr int kRowsPerCta = kThreads / 32 * kRowsPerWarp;
constexpr int kFillCtas = 4;  // CTAs an SM at least for kRowsPerWarp rows a warp
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ __nv_bfloat16 to_bf16(int v) {
  return __float2bfloat16_rn(__int2float_rn(v));
}

__device__ __forceinline__ int back(__nv_bfloat16 b) { return __bfloat162int_rz(b); }

// A 16-bit value's bits as a register for a shuffle, and back.
__device__ __forceinline__ int bits(__nv_bfloat16 b) { return __bfloat16_as_ushort(b); }
__device__ __forceinline__ __nv_bfloat16 bf16_bits(int v) {
  return __ushort_as_bfloat16((unsigned short)v);
}

// The probe's output for the 4 elements a lane t holds of one row (x: the
// row's input, or the row before for bf16_rowroll).
template <int P>
__device__ __forceinline__ int4 body(int4 x, int t) {
  const int e[4] = {x.x, x.y, x.z, x.w};
  int r[4];
  if constexpr (P == kBf16Roll) {
    __nv_bfloat16 b[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) b[k] = to_bf16(e[k]);
    r[0] = back(bf16_bits(__shfl_sync(kFull, bits(b[3]), (t + 31) & 31)));
#pragma unroll
    for (int k = 1; k < 4; ++k) r[k] = back(b[k - 1]);
  } else if constexpr (P == kI16Roll || P == kCanaryI16Roll) {
    short s[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) s[k] = (short)e[k];
    r[0] = (short)__shfl_sync(kFull, (int)s[3], (t + 31) & 31);
#pragma unroll
    for (int k = 1; k < 4; ++k) r[k] = s[k - 1];
  } else if constexpr (P == kBf16Max) {
    const __nv_bfloat16 half = __float2bfloat16_rn(0.5f);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      __nv_bfloat16 b = to_bf16(e[k]);
      r[k] = back(__hmax(b, __hmul(b, half)));
    }
  } else if constexpr (P == kBf16Select) {
    const __nv_bfloat16 neg1 = __float2bfloat16_rn(-1.0f);
#pragma unroll
    for (int k = 0; k < 4; ++k) r[k] = back(4 * t + k >= 5 ? to_bf16(e[k]) : neg1);
  } else if constexpr (P == kBf16RowRoll) {
#pragma unroll
    for (int k = 0; k < 4; ++k) r[k] = back(to_bf16(e[k]));
  } else if constexpr (P == kBf16Scan7) {
    const __nv_bfloat16 neg1 = __float2bfloat16_rn(-1.0f);
    __nv_bfloat16 s[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      s[k] = (e[k] & 3) == 0 ? neg1 : __int2bfloat16_rn(4 * t + k);
      if (k) s[k] = __hmax(s[k], s[k - 1]);
    }
    // the lanes' maxima, scanned across the warp; then the lanes before each
    __nv_bfloat16 incl = s[3];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      __nv_bfloat16 y = bf16_bits(__shfl_up_sync(kFull, bits(incl), o));
      if (t >= o) incl = __hmax(incl, y);
    }
    __nv_bfloat16 before = bf16_bits(__shfl_up_sync(kFull, bits(incl), 1));
    if (t == 0) before = neg1;
#pragma unroll
    for (int k = 0; k < 4; ++k) r[k] = back(__hmax(s[k], before));
  } else {  // kCanaryStrided: the row itself
#pragma unroll
    for (int k = 0; k < 4; ++k) r[k] = e[k];
  }
  return make_int4(r[0], r[1], r[2], r[3]);
}

// rpw: rows a warp, kRowsPerWarp or 1; the CTA's warps from blockDim.
template <int P>
__global__ void __launch_bounds__(kThreads)
    probe16_kernel(const int* __restrict__ x, int* __restrict__ out, int rows, int rpw) {
  const int t = threadIdx.x & 31;
  const int r0 = (blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5)) * rpw;
  const int out_rows = P == kCanaryStrided ? (rows + 1) / 2 : rows;
  int4 v[kRowsPerWarp];
#pragma unroll
  for (int j = 0; j < kRowsPerWarp; ++j) {
    const int r = r0 + j;
    int src = P == kCanaryStrided ? 2 * r : P == kBf16RowRoll ? (r == 0 ? rows - 1 : r - 1) : r;
    v[j] = j < rpw && r < out_rows ? reinterpret_cast<const int4*>(x + (size_t)src * kLanes)[t]
                                   : make_int4(0, 0, 0, 0);
  }
#pragma unroll
  for (int j = 0; j < kRowsPerWarp; ++j) {
    const int r = r0 + j;
    if (j >= rpw || r >= out_rows) break;  // uniform across the warp
    reinterpret_cast<int4*>(out + (size_t)r * kLanes)[t] = body<P>(v[j], t);
  }
}

// The launch for out_rows output rows on sms SMs: (CTAs, threads a CTA,
// rows a warp). tests/test_torch_mxu_probes.py mirrors it.
struct Grid {
  int ctas, threads, rpw;
};

inline Grid grid_of(int out_rows, int sms) {
  if (out_rows >= kFillCtas * sms * kRowsPerCta)
    return {(out_rows + kRowsPerCta - 1) / kRowsPerCta, kThreads, kRowsPerWarp};
  int warps = (out_rows + sms - 1) / sms;
  warps = warps < kThreads / 32 ? warps : kThreads / 32;
  return {(out_rows + warps - 1) / warps, 32 * warps, 1};
}

template <int P>
int launch_probe16(const int* x, int* out, int rows, cudaStream_t s) {
  int dev = 0, sms = 0;
  int err = (int)cudaGetDevice(&dev);
  if (!err) err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err) return err;
  Grid g = grid_of(P == kCanaryStrided ? (rows + 1) / 2 : rows, sms);
  probe16_kernel<P><<<g.ctas, g.threads, 0, s>>>(x, out, rows, g.rpw);
  return (int)cudaGetLastError();
}

}  // namespace

// probe: 0..7 in tools_cuda.PROBES16's order. x: rows int32 rows of 128;
// out: rows rows (strided_sublane: ceil(rows / 2)), both 16-byte aligned;
// rows positive, rows * 128 below 2**31 (checked by the wrapper). Returns
// the launch's CUDA error, or cudaErrorInvalidValue for another probe or no
// rows. The grid depends on the current device's SM count (grid_of).
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

template <int P>
int least_ctas(int* ctas) {
  int n = 0;
  int err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, probe16_kernel<P>, kThreads, 0);
  if (!err && (P == 0 || n < *ctas)) *ctas = n;
  return err;
}

// The least CTAs per SM of the eight probe kernels on the current device, as
// the CUDA runtime computes them. Returns the first nonzero CUDA error.
extern "C" int blt_probe16_ctas_per_sm(int* ctas) {
  int (*const each[])(int*) = {least_ctas<0>, least_ctas<1>, least_ctas<2>, least_ctas<3>,
                               least_ctas<4>, least_ctas<5>, least_ctas<6>, least_ctas<7>};
  int err = 0;
  for (int p = 0; p < 8 && !err; ++p) err = each[p](ctas);
  return err;
}
