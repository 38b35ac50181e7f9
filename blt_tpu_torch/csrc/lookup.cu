// Pair -> value lookup designs over a packed table: T13.
//
// Replaces: tools/exp_gather.py::make_pallas (bodies body_chain, body_g2d,
// body_g2d_flat, body_gax0, body_g8bit), once and chained.
//
// Functions, i32[rows, 128] -> i32[rows, 128], each element's input q taken
// to 16 bits first (the tool feeds 0 <= p < 65536, and outside that range
// its bodies disagree with each other; no read here leaves its table):
//   q = p & 0xFFFF, or in a link of the tool's chain (c the previous output,
//   p itself at the first link) q = (p + (c & 1)) & 0xFFFF, fused here as a
//   prologue so that a link is one launch;
//   chain, g2d, g2d_flat: val16[q] from the packed table i32[256, 128]: the
//     word h = q >> 1 (row h >> 7, lane h & 127), its high half if q is
//     odd, else its low half;
//   gax0: the packed word itself at row q >> 8 and the element's own lane;
//   g8bit: tbl8[(q >> 7) & 31, q & 127] from a u8[32, 128] table.
//
// Designs (the template's variant), one per tool body:
//   g2d_flat: the word read from the table in device memory through the
//     read-only data cache (__ldg), the flattened jnp.take;
//   g2d: the table staged in 128 KB of dynamic shared memory, on a
//     persistent grid of one block per SM that fills it once;
//   chain: the tool's 256-segment select chain as written (read segment s
//     at lane h & 127, keep it where s == h >> 7), over the staged table:
//     the TPU's baseline design, to show what a select chain costs beside a
//     gather;
//   gax0, g8bit: from the staged table, as probes against their own
//     references.
// Each thread takes 4 consecutive elements per step (16-byte loads and
// stores) in a grid-stride loop.
//
// Bound on the H100: the bytes. A link reads p and c and writes out, 12
// bytes per element, plus the table once (128 KB): 192 MiB at 16 Mi
// elements, about 60 us at 3.35 TB/s; at the tool's 512 Ki elements 6 MiB,
// about 2 us, so launch-bound. chain's 256 shared-memory reads per element
// bound it by operations instead.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

enum Lookup : int { kChain = 0, kG2d = 1, kG2dFlat = 2, kGax0 = 3, kG8bit = 4 };

constexpr int kLookupThreads = 1024;
constexpr int kPackedWords = 256 * 128;
constexpr int kTbl8Words = 32 * 128 / 4;

__device__ __forceinline__ int unpack(int w, int q) {
  return (q & 1) ? (w >> 16) & 0xFFFF : w & 0xFFFF;
}

template <int V>
__device__ __forceinline__ int lookup_one(const int* __restrict__ t, int q,
                                          int lane) {
  int h = q >> 1;
  if constexpr (V == kG2dFlat) {
    return unpack(__ldg(t + h), q);
  } else if constexpr (V == kG2d) {
    return unpack(t[h], q);
  } else if constexpr (V == kChain) {
    int hi = h >> 7;
    int lo = h & 127;
    int acc = 0;
#pragma unroll 8
    for (int s = 0; s < 256; ++s) {
      int g = t[s * 128 + lo];
      acc = hi == s ? g : acc;
    }
    return unpack(acc, q);
  } else if constexpr (V == kGax0) {
    return t[(q >> 8) * 128 + lane];
  } else {
    return reinterpret_cast<const uint8_t*>(t)[q & 4095];
  }
}

template <int V>
__global__ void __launch_bounds__(kLookupThreads)
    lookup_kernel(const int* __restrict__ tbl, const int* __restrict__ p,
                  const int* __restrict__ c, int* __restrict__ out, int groups) {
  constexpr bool kStaged = V != kG2dFlat;
  constexpr int kWords = V == kG8bit ? kTbl8Words : kPackedWords;
  extern __shared__ int4 staged[];
  const int* t = tbl;
  if constexpr (kStaged) {
    for (int k = threadIdx.x; k < kWords / 4; k += blockDim.x) {
      staged[k] = reinterpret_cast<const int4*>(tbl)[k];
    }
    __syncthreads();
    t = reinterpret_cast<const int*>(staged);
  }
  for (int g = blockIdx.x * blockDim.x + threadIdx.x; g < groups;
       g += gridDim.x * blockDim.x) {
    int4 pv = reinterpret_cast<const int4*>(p)[g];
    int pp[4] = {pv.x, pv.y, pv.z, pv.w};
    int q[4];
    if (c) {
      int4 cv = reinterpret_cast<const int4*>(c)[g];
      int cc[4] = {cv.x, cv.y, cv.z, cv.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) q[k] = (pp[k] + (cc[k] & 1)) & 0xFFFF;
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) q[k] = pp[k] & 0xFFFF;
    }
    int r[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) r[k] = lookup_one<V>(t, q[k], (4 * g + k) & 127);
    reinterpret_cast<int4*>(out)[g] = make_int4(r[0], r[1], r[2], r[3]);
  }
}

template <int V>
int launch_lookup(const int* tbl, const int* p, const int* c, int* out, int n,
                  cudaStream_t s) {
  constexpr bool kStaged = V != kG2dFlat;
  size_t smem = kStaged ? (V == kG8bit ? kTbl8Words : kPackedWords) * sizeof(int) : 0;
  int groups = n / 4;
  int want = (groups + kLookupThreads - 1) / kLookupThreads;
  int dev, sms;
  int err = (int)cudaGetDevice(&dev);
  if (!err) err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (!err && kStaged) {
    err = (int)cudaFuncSetAttribute(lookup_kernel<V>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)smem);
  }
  if (err) return err;
  // staged: one block per SM fills its table once; g2d_flat: two per SM
  int cap = kStaged ? sms : 2 * sms;
  int grid = want < 1 ? 1 : (want < cap ? want : cap);
  lookup_kernel<V><<<grid, kLookupThreads, smem, s>>>(tbl, p, c, out, groups);
  return (int)cudaGetLastError();
}

}  // namespace

// variant: chain 0, g2d 1, g2d_flat 2, gax0 3, g8bit 4 (tools_cuda.LOOKUPS).
// tbl: the packed int32[256 * 128], or for g8bit the u8[32 * 128]; p, c
// (null for a lookup of p itself), out: n int32, n a positive multiple of 4
// below 2**31, all 16-byte aligned (checked by the wrapper). Returns the
// first nonzero CUDA error, or cudaErrorInvalidValue for another variant.
extern "C" int blt_lookup(int variant, const void* tbl, const void* p,
                          const void* c, void* out, int n, void* stream) {
  auto t = (const int*)tbl;
  auto pp = (const int*)p;
  auto cc = (const int*)c;
  auto o = (int*)out;
  auto s = (cudaStream_t)stream;
  switch (variant) {
    case kChain: return launch_lookup<kChain>(t, pp, cc, o, n, s);
    case kG2d: return launch_lookup<kG2d>(t, pp, cc, o, n, s);
    case kG2dFlat: return launch_lookup<kG2dFlat>(t, pp, cc, o, n, s);
    case kGax0: return launch_lookup<kGax0>(t, pp, cc, o, n, s);
    case kG8bit: return launch_lookup<kG8bit>(t, pp, cc, o, n, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
