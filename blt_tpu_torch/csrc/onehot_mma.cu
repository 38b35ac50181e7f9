// One-hot matrix product lookup on the tensor cores: T14.
//
// Replaces: tools/exp_gather.py::make_pmxu (kernel :190-209), the fused
// "MXU" lookup in int8 and in bf16, once and chained.
//
// Function, per position of i32[m] (the tool's (m, 1) column; p taken as
// given, or in a link of the tool's chain, c the previous output, q = (p +
// (c & 1)) & 0xFFFF fused here as a prologue so that a link is one launch):
//   a = q >> 8 (arithmetic), b = q & 255;
//   r = onehot(a) (1, 256) @ planes (256, 512), all zero for a outside
//     [0, 256);
//   out = (r[256 + b] + off) * 256 + (r[b] + off).
// int8: planes (lo - 128 | hi - 128) as s8, s32 accumulation, off 128; bf16:
// planes (lo | hi) as bf16, f32 accumulation taken to int32 toward zero, off
// 0. Inside the domain out = val16[q]; outside, r = 0 gives 32896 (int8) and
// 0 (bf16), as the TPU kernel does.
//
// Design: the whole product on the tensor cores, as the TPU kernel runs it
// on its MXU (the tool's question is whether the one-hot product beats a
// gather, so neither a gather nor the selected column alone stands in for
// it). Hand-written mma.sync in PTX: m16n8k32 s8.s8 -> s32, m16n8k16
// bf16.bf16 -> f32. A warp takes 32 positions (two 16-row m-tiles) at a
// time:
//   - A, the one-hot rows, is built in registers: each thread knows which
//     (row, k) elements its fragment holds, so a fragment register is a
//     compare of the row's a against the register's first k;
//   - B, the planes, comes from dynamic shared memory, staged once per block
//     in fragment order, so a lane's two B registers of two k-steps are one
//     conflict-free 16-byte load. The int8 planes are 128 KB and are staged
//     whole; the bf16 planes are 256 KB, past a block's 227 KB, and are
//     staged as two slabs of 256 columns (lo, then hi): the block walks its
//     positions once per slab, and the hi pass adds to what the lo pass
//     wrote;
//   - selection: each accumulator element keeps its value where its column
//     is the row's b (or 256 + b), and the one lane of the quad that holds
//     it passes it on with two xor shuffles.
// A persistent grid of one block per SM (128 KB of shared memory each)
// walks tiles of `tile` positions (the tool's grid step, a multiple of 16
// that divides m); the warps of a block share a tile.
//
// Bound on the H100: the tensor-core operations, 2 * 256 * 512 per position:
// at 16 Mi positions 4.4e12, 2.22 ms at 1979 TOP/s int8 and 4.45 ms at 989
// TFLOP/s bf16, against 0.060 ms for the bytes (p, c, out and the planes).
// mma.sync reaches only part of that peak (wgmma, which reaches all of it,
// and TMA are work for a later change); shared memory feeds B at 128 bytes
// per mma.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

enum MxuType : int { kInt8 = 0, kBf16 = 1 };

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMTiles = 2;  // 16-row m-tiles a warp runs per B load
constexpr int kSlabBytes = 128 * 1024;

template <int T>
struct Mxu;

template <>
struct Mxu<kInt8> {
  using Acc = int;
  static constexpr int kK = 32;      // mma depth
  static constexpr int kSlabs = 1;   // 256 x 512 s8: 128 KB
  static constexpr int kOff = 128;
};

template <>
struct Mxu<kBf16> {
  using Acc = float;
  static constexpr int kK = 16;
  static constexpr int kSlabs = 2;   // 256 x 512 bf16: two slabs of 128 KB
  static constexpr int kOff = 0;
};

__device__ __forceinline__ void mma(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ int to_int(int v) { return v; }
__device__ __forceinline__ int to_int(float v) { return __float2int_rz(v); }

// A fragment register i of k-step s for a row whose one-hot index is a. Its
// elements (kK / 8 of them, lowest in the low bits) are the columns s * kK +
// (i >> 1) * kK / 2 + t * kK / 8 + e, of row g (i even) or g + 8 (i odd), t
// the lane's place in its quad: PTX's layouts of m16n8k32 .s8 and m16n8k16
// .bf16.
template <int T>
__device__ __forceinline__ uint32_t onehot(int a, int s, int i, int t) {
  constexpr int kK = Mxu<T>::kK;
  constexpr int kE = kK / 8;
  unsigned d = (unsigned)(a - (s * kK + (i >> 1) * (kK / 2) + t * kE));
  if (d >= (unsigned)kE) return 0u;
  return T == kInt8 ? 1u << (8 * d) : 0x3F80u << (16 * d);  // s8 1, bf16 1.0
}

// B fragment register r of k-step s, column n, for lane quad place t: rows
// s * kK + r * kK / 2 + t * kK / 8 + e of the row-major (256, 512) planes.
template <int T>
__device__ __forceinline__ uint32_t b_word(const void* planes, int s, int r, int t, int n) {
  constexpr int kK = Mxu<T>::kK;
  int k0 = s * kK + r * (kK / 2) + t * (kK / 8);
  uint32_t w = 0;
  if constexpr (T == kInt8) {
    auto p8 = static_cast<const uint8_t*>(planes);
#pragma unroll
    for (int e = 0; e < 4; ++e) w |= (uint32_t)p8[(k0 + e) * 512 + n] << (8 * e);
  } else {
    auto p16 = static_cast<const uint16_t*>(planes);
#pragma unroll
    for (int e = 0; e < 2; ++e) w |= (uint32_t)p16[(k0 + e) * 512 + n] << (16 * e);
  }
  return w;
}

template <int T>
__global__ void __launch_bounds__(kThreads, 1)
    pmxu_kernel(const void* __restrict__ planes, const int* __restrict__ p,
                const int* __restrict__ c, int* __restrict__ out, int m, int tile) {
  using Acc = typename Mxu<T>::Acc;
  constexpr int kK = Mxu<T>::kK;
  constexpr int kSteps = 256 / kK;
  constexpr int kPairs = kSteps / 2;               // k-steps per 16-byte B load: 2
  constexpr int kSlabCols = 512 / Mxu<T>::kSlabs;
  constexpr int kNTiles = kSlabCols / 8;
  constexpr int kOff = Mxu<T>::kOff;
  static_assert(kNTiles * kPairs * 32 * 16 == kSlabBytes, "a slab fills the staged planes");

  extern __shared__ uint4 frag[];  // [n-tile][k-step pair][lane]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int tiles = m / tile;
  const int groups = (tile + 16 * kMTiles - 1) / (16 * kMTiles);

  for (int slab = 0; slab < Mxu<T>::kSlabs; ++slab) {
    const int col0 = slab * kSlabCols;
    __syncthreads();  // every warp is done with the slab before
    for (int u = threadIdx.x; u < kNTiles * kPairs * 32; u += kThreads) {
      int l = u & 31;
      int sp = (u >> 5) % kPairs;
      int n = col0 + 8 * ((u >> 5) / kPairs) + (l >> 2);
      int lt = l & 3;
      frag[u] = make_uint4(b_word<T>(planes, 2 * sp, 0, lt, n), b_word<T>(planes, 2 * sp, 1, lt, n),
                           b_word<T>(planes, 2 * sp + 1, 0, lt, n),
                           b_word<T>(planes, 2 * sp + 1, 1, lt, n));
    }
    __syncthreads();

    for (int tl = blockIdx.x; tl < tiles; tl += gridDim.x) {
      const int end = (tl + 1) * tile;
      for (int grp = warp; grp < groups; grp += kWarps) {
        const int base = tl * tile + grp * 16 * kMTiles;
        int a[kMTiles][2], b[kMTiles][2];
#pragma unroll
        for (int mt = 0; mt < kMTiles; ++mt) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            int pos = base + 16 * mt + g + 8 * h;
            int q = -1;  // past the tile: an all-zero one-hot row, never stored
            if (pos < end) {
              q = p[pos];
              if (c) q = (q + (c[pos] & 1)) & 0xFFFF;
            }
            a[mt][h] = q >> 8;
            b[mt][h] = q & 255;
          }
        }
        uint32_t A[kMTiles][kSteps][4];
#pragma unroll
        for (int mt = 0; mt < kMTiles; ++mt) {
#pragma unroll
          for (int s = 0; s < kSteps; ++s) {
#pragma unroll
            for (int i = 0; i < 4; ++i) A[mt][s][i] = onehot<T>(a[mt][i & 1], s, i, t);
          }
        }
        Acc lo[kMTiles][2] = {}, hi[kMTiles][2] = {};
        for (int j = 0; j < kNTiles; j += 2) {  // two n-tiles per pass over k
          Acc acc[kMTiles][2][4] = {};
#pragma unroll
          for (int sp = 0; sp < kPairs; ++sp) {
            uint4 bq[2];
#pragma unroll
            for (int nt = 0; nt < 2; ++nt) bq[nt] = frag[((j + nt) * kPairs + sp) * 32 + lane];
#pragma unroll
            for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
              for (int mt = 0; mt < kMTiles; ++mt) {
                mma(acc[mt][nt], A[mt][2 * sp], bq[nt].x, bq[nt].y);
                mma(acc[mt][nt], A[mt][2 * sp + 1], bq[nt].z, bq[nt].w);
              }
            }
          }
          // accumulator element 2h + e: row g + 8h, column n0 + 2t + e
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            const int n0 = col0 + 8 * (j + nt) + 2 * t;
#pragma unroll
            for (int mt = 0; mt < kMTiles; ++mt) {
#pragma unroll
              for (int h = 0; h < 2; ++h) {
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                  Acc v = acc[mt][nt][2 * h + e];
                  lo[mt][h] = n0 + e == b[mt][h] ? v : lo[mt][h];
                  hi[mt][h] = n0 + e == 256 + b[mt][h] ? v : hi[mt][h];
                }
              }
            }
          }
        }
#pragma unroll
        for (int mt = 0; mt < kMTiles; ++mt) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            // one lane of the quad holds each value, the others hold 0
#pragma unroll
            for (int x = 1; x < 4; x <<= 1) {
              lo[mt][h] += __shfl_xor_sync(0xFFFFFFFFu, lo[mt][h], x);
              hi[mt][h] += __shfl_xor_sync(0xFFFFFFFFu, hi[mt][h], x);
            }
            int pos = base + 16 * mt + g + 8 * h;
            if (t == 0 && pos < end) {
              int vlo = to_int(lo[mt][h]) + kOff;
              int vhi = to_int(hi[mt][h]) + kOff;
              if (Mxu<T>::kSlabs == 1) {
                out[pos] = vhi * 256 + vlo;
              } else if (slab == 0) {
                out[pos] = vlo;  // this thread adds the hi plane in the next slab
              } else {
                out[pos] = vhi * 256 + out[pos];
              }
            }
          }
        }
      }
    }
  }
}

template <int T>
int launch_pmxu(const void* planes, const int* p, const int* c, int* out, int m, int tile,
                cudaStream_t s) {
  int dev, sms;
  int err = (int)cudaGetDevice(&dev);
  if (!err) err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (!err) {
    err = (int)cudaFuncSetAttribute(pmxu_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    kSlabBytes);
  }
  if (err) return err;
  int tiles = m / tile;
  int grid = tiles < sms ? tiles : sms;
  pmxu_kernel<T><<<grid, kThreads, kSlabBytes, s>>>(planes, p, c, out, m, tile);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: int8 0, bf16 1 (tools_cuda.MXU_LOOKUPS). planes: the row-major
// (256, 512) s8 or bf16 planes; p, c (null for a lookup of p itself), out: m
// int32; tile a positive multiple of 16 that divides m, m below 2**31
// (checked by the wrapper). Returns the first nonzero CUDA error, or
// cudaErrorInvalidValue for another dtype or shape.
extern "C" int blt_pmxu(int dtype, const void* planes, const void* p, const void* c, void* out,
                        int m, int tile, void* stream) {
  if (m <= 0 || tile <= 0 || tile % 16 || m % tile) return (int)cudaErrorInvalidValue;
  auto pp = (const int*)p;
  auto cc = (const int*)c;
  auto o = (int*)out;
  auto s = (cudaStream_t)stream;
  switch (dtype) {
    case kInt8: return launch_pmxu<kInt8>(planes, pp, cc, o, m, tile, s);
    case kBf16: return launch_pmxu<kBf16>(planes, pp, cc, o, m, tile, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
