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
// it, and no k-step is skipped where a tile's one-hot rows are zero).
// Hopper's warpgroup product, hand-written in PTX: wgmma.mma_async
// m64n256k32 s8.s8 -> s32 and m64n256k16 bf16.bf16 -> f32, A from registers,
// B from shared memory through a matrix descriptor.
//   - A, the one-hot rows of 64 positions, is built in registers once per
//     64-row tile: the m64 fragment is, per warp, the m16 fragment of the
//     warp-level m16n8 product, a register holding 4 (s8) or 2 (bf16) columns, so
//     it is a compare of the row's column block a >> 2 (a >> 1) against the
//     register's and a select of the row's one-hot word;
//   - B, a plane (256 rows of K by 256 columns: lo, or hi), is one n256
//     operand. Both planes are staged in shared memory as the image that
//     tools_cuda.mxu_image lays out once per planes tensor: K-major (s8 has
//     no transpose; bf16 takes the same layout), in the canonical 128-byte
//     swizzle: per plane, K slices of 128 bytes (32 KB each), in each 32
//     groups of 8 columns 1024 bytes apart (SBO), a column's 128 bytes in
//     one row, its 16-byte chunk i at i ^ (column & 7). A k-step's
//     descriptor starts at its slice plus 32 bytes a step. The image comes
//     in by cp.async.bulk (8 copies of 16 KB) completing on an mbarrier;
//   - bf16's planes are 256 KB, past a block's 227 KB: the block stages lo,
//     walks its positions, stages hi and walks them again, adding to what
//     the same thread wrote (a cluster of two blocks meeting in distributed
//     shared memory would save the second read of p, c and out, 0.2 ms of
//     bytes at 16 Mi positions against 4.4 ms of operations, and cost a
//     cluster barrier a tile). The int8 planes (128 KB) are staged at once;
//   - selection: an accumulator thread holds columns 8j + 2t + e of rows g
//     and g + 8; a mux by b's bits (32 selects by bit 0, then 31 by bits 3..7)
//     leaves column b in the quad's lane t == (b >> 1) & 3, which also holds
//     column 256 + b of the hi plane and stores the position: no shuffle;
//   - two warpgroups take turns on the tensor cores: each issues a plane's
//     k-steps (8 or 16 wgmma), commits and waits, and selects while the
//     other's wgmmas run. The next tile's p (and c) is loaded before the
//     wait.
// A persistent grid of one block per SM (256 threads, 129 KB of shared
// memory) walks tiles of `tile` positions (the tool's grid step, a multiple
// of 16 that divides m); a block's (tile, 64-row group) items alternate
// between its warpgroups, the same way in both bf16 passes. A 64-row group
// that runs past its tile masks the extra rows: q = -1 is an all-zero
// one-hot row, never stored.
//
// Bound on the H100: the tensor-core operations, 2 * 256 * 512 per position:
// at 16 Mi positions 4.4e12, 2.22 ms at 1979 TOP/s int8 and 4.45 ms at 989
// TFLOP/s bf16, against 0.060 ms for the bytes (p, c, out and the planes).
// On an H100 80GB HBM3 at 700 W (chip_smoke.py phase 7, 16 Mi positions,
// tile 512) it takes 2.58 ms int8 and 5.25 ms bf16, 86 % and 85 % of that
// bound. What holds the rest: the gaps between a warpgroup's batches (its
// select, one-hot build and loads, when they outlast the other's batch),
// the clock under load, and below 64-position tiles the masked rows.
// ptxas (sm_90a): 212 registers int8, 221 bf16 (128 accumulators, 32 or 64
// of A), no spills, no stack; 16 IGMMA (int8) and 16 HGMMA (bf16) in SASS.
// The select's mux keeps constant indices: a loop whose bound varies with
// an outer loop left it in local memory, and the kernel took 2 (bf16) to 4
// (int8) times as long.

#include <cstdint>
#include <cuda_runtime.h>

#include "bulk.cuh"

namespace {

enum MxuType : int { kInt8 = 0, kBf16 = 1 };

constexpr int kWarpgroups = 2;
constexpr int kThreads = 128 * kWarpgroups;
constexpr int kRows = 64;                 // positions per wgmma (m64)
constexpr int kSliceBytes = 256 * 128;    // one 128-byte K slice of a plane's 256 columns
constexpr int kStageBytes = 128 * 1024;   // shared memory for planes
constexpr int kCopyBytes = 16 * 1024;     // one cp.async.bulk
constexpr int kSmemBytes = kStageBytes + 1024 + 16;  // + alignment to 1024, the mbarrier

template <int T>
struct Mxu;

template <>
struct Mxu<kInt8> {
  using Acc = int;
  static constexpr int kSteps = 8;     // k32 steps over K = 256
  static constexpr int kPlanes = 2;    // planes staged at once: 64 KB each
  static constexpr int kOff = 128;
};

template <>
struct Mxu<kBf16> {
  using Acc = float;
  static constexpr int kSteps = 16;    // k16 steps
  static constexpr int kPlanes = 1;    // 128 KB each: one pass per plane
  static constexpr int kOff = 0;
};

#define BLT_ACC8(C, d, i)                                                                 \
  C(d[i]), C(d[i + 1]), C(d[i + 2]), C(d[i + 3]), C(d[i + 4]), C(d[i + 5]), C(d[i + 6]), \
      C(d[i + 7])
#define BLT_ACC128(C, d)                                                                   \
  BLT_ACC8(C, d, 0), BLT_ACC8(C, d, 8), BLT_ACC8(C, d, 16), BLT_ACC8(C, d, 24),           \
      BLT_ACC8(C, d, 32), BLT_ACC8(C, d, 40), BLT_ACC8(C, d, 48), BLT_ACC8(C, d, 56),     \
      BLT_ACC8(C, d, 64), BLT_ACC8(C, d, 72), BLT_ACC8(C, d, 80), BLT_ACC8(C, d, 88),     \
      BLT_ACC8(C, d, 96), BLT_ACC8(C, d, 104), BLT_ACC8(C, d, 112), BLT_ACC8(C, d, 120)
#define BLT_RW_I(x) "+r"(x)
#define BLT_RW_F(x) "+f"(x)
#define BLT_D128                                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                 \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "        \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "        \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "        \
  "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "        \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "        \
  "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "  \
  "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, "    \
  "%125, %126, %127}"

// d (+)= A (64 x 32 s8, registers) @ B (32 x 256 s8, the descriptor's), s32;
// d is overwritten where scale_d is 0.
__device__ __forceinline__ void wgmma(int (&d)[128], const uint32_t (&a)[4], uint64_t desc,
                                      int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 " BLT_D128
      ", {%128, %129, %130, %131}, %132, p;\n}\n"
      : BLT_ACC128(BLT_RW_I, d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// d (+)= A (64 x 16 bf16, registers) @ B (16 x 256 bf16, K-major), f32.
__device__ __forceinline__ void wgmma(float (&d)[128], const uint32_t (&a)[4], uint64_t desc,
                                      int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " BLT_D128
      ", {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      : BLT_ACC128(BLT_RW_F, d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous product's fence and wait: the registers pass through an asm.
__device__ __forceinline__ void fence_reg(int& r) { asm volatile("" : "+r"(r)::"memory"); }
__device__ __forceinline__ void fence_reg(float& r) { asm volatile("" : "+f"(r)::"memory"); }

template <typename Acc>
__device__ __forceinline__ void fence_acc(Acc (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) fence_reg(d[i]);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

__device__ __forceinline__ int to_int(int v) { return v; }
__device__ __forceinline__ int to_int(float v) { return __float2int_rz(v); }

// Column b (0..255) of row g + 8h of the warp's 16, as this lane holds it:
// d[4j + 2h + e] is column 8j + 2t + e, so the lane with t == (b >> 1) & 3
// gets column b, the others another column. A mux: e by b's bit 0, then j by
// bits 7..3.
template <typename Acc>
__device__ __forceinline__ Acc pick(const Acc (&d)[128], int h, int b) {
  Acc x[32];
  const bool odd = b & 1;
#pragma unroll
  for (int j = 0; j < 32; ++j) x[j] = odd ? d[4 * j + 2 * h + 1] : d[4 * j + 2 * h];
  // one loop of constant bounds per level, so that every index is a
  // constant and x stays in registers
#pragma unroll
  for (int j = 0; j < 16; ++j) x[j] = (b & 128) ? x[j + 16] : x[j];
#pragma unroll
  for (int j = 0; j < 8; ++j) x[j] = (b & 64) ? x[j + 8] : x[j];
#pragma unroll
  for (int j = 0; j < 4; ++j) x[j] = (b & 32) ? x[j + 4] : x[j];
#pragma unroll
  for (int j = 0; j < 2; ++j) x[j] = (b & 16) ? x[j + 2] : x[j];
  return (b & 8) ? x[1] : x[0];
}

template <int T>
__global__ void __launch_bounds__(kThreads, 1)
    pmxu_kernel(const uint8_t* __restrict__ image, const int* __restrict__ p,
                const int* __restrict__ c, int* __restrict__ out, int m, int tile) {
  using Acc = typename Mxu<T>::Acc;
  constexpr int kSteps = Mxu<T>::kSteps;
  constexpr int kPlanes = Mxu<T>::kPlanes;
  constexpr int kPlaneBytes = kStageBytes / kPlanes;
  constexpr int kOff = Mxu<T>::kOff;

  extern __shared__ uint8_t smem[];
  const uint32_t img = ((uint32_t)__cvta_generic_to_shared(smem) + 1023u) & ~1023u;
  const uint32_t bar = img + kStageBytes;
  // K-major, 128-byte swizzle (1 << 62), SBO 1024 bytes, LBO 1 (unused)
  const uint64_t desc0 = (uint64_t)((img >> 4) & 0x3FFF) | (1ull << 16) | (64ull << 32) |
                         (1ull << 62);
  const int wg = threadIdx.x >> 7;
  const int wl = (threadIdx.x >> 5) & 3;  // warp of the warpgroup: rows 16 wl ..
  const int g = (threadIdx.x & 31) >> 2;
  const int t = threadIdx.x & 3;
  const int tiles = m / tile;
  const int groups = (tile + kRows - 1) / kRows;
  const int items = ((tiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1) * groups;

  // item -> its first row here (position of row g; row g + 8 is 8 on) and
  // the end of its tile
  auto row0 = [&](int it, int& end) {
    const int tl = (int)blockIdx.x + (it / groups) * (int)gridDim.x;
    end = (tl + 1) * tile;
    return tl * tile + (it % groups) * kRows + 16 * wl + g;
  };
  auto load = [&](int it, int (&q)[2]) {
    int end = 0;
    const int pos = it < items ? row0(it, end) : 0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      q[h] = -1;  // past the tile: an all-zero one-hot row, never stored
      if (pos + 8 * h < end) {
        q[h] = p[pos + 8 * h];
        if (c) q[h] = (q[h] + (c[pos + 8 * h] & 1)) & 0xFFFF;
      }
    }
  };

  if (threadIdx.x == 0) mbar_init(bar);
  __syncthreads();

  Acc acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0;

  for (int pass = 0; pass < 2 / kPlanes; ++pass) {
    if (pass) __syncthreads();  // every warpgroup has waited on its products of the last plane
    if (threadIdx.x == 0) stage(img, image + pass * kStageBytes, kStageBytes, kCopyBytes, bar);
    mbar_wait(bar, pass & 1);

    int q[2];
    load(wg, q);
    for (int it = wg; it < items; it += kWarpgroups) {
      int a[2], b[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        a[h] = q[h] >> 8;
        b[h] = q[h] & 255;
      }
      // fragment register i of k-step s: row g + 8 (i & 1), column block
      // 8 s + 4 (i >> 1) + t of 4 s8 (2 bf16) columns
      uint32_t A[kSteps][4];
      int blk[2];
      uint32_t word[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if constexpr (T == kInt8) {
          blk[h] = (a[h] >> 2) - t;
          word[h] = 1u << (8 * (a[h] & 3));  // s8 1
        } else {
          blk[h] = (a[h] >> 1) - t;
          word[h] = (a[h] & 1) ? 0x3F800000u : 0x3F80u;  // bf16 1.0
        }
      }
#pragma unroll
      for (int s = 0; s < kSteps; ++s) {
#pragma unroll
        for (int i = 0; i < 4; ++i) A[s][i] = blk[i & 1] == 8 * s + 4 * (i >> 1) ? word[i & 1] : 0u;
      }

      int qn[2];
      Acc v[kPlanes][2];
#pragma unroll
      for (int pl = 0; pl < kPlanes; ++pl) {
        fence_acc(acc);
        wgmma_fence();
#pragma unroll
        for (int s = 0; s < kSteps; ++s) {
          const uint32_t off = pl * kPlaneBytes + (s >> 2) * kSliceBytes + (s & 3) * 32;
          wgmma(acc, A[s], desc0 + (off >> 4), s > 0);
        }
        wgmma_commit();
        if (pl == kPlanes - 1) load(it + kWarpgroups, qn);
        wgmma_wait();
        fence_acc(acc);
#pragma unroll
        for (int h = 0; h < 2; ++h) v[pl][h] = pick(acc, h, b[h]);
      }

      int end;
      const int pos = row0(it, end);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (pos + 8 * h < end && t == ((b[h] >> 1) & 3)) {
          int* o = out + pos + 8 * h;
          if constexpr (kPlanes == 2) {
            *o = (to_int(v[1][h]) + kOff) * 256 + to_int(v[0][h]) + kOff;
          } else if (pass == 0) {
            *o = to_int(v[0][h]) + kOff;  // this thread adds the hi plane in the next pass
          } else {
            *o = (to_int(v[0][h]) + kOff) * 256 + *o;
          }
        }
        q[h] = qn[h];
      }
    }
  }
}

template <int T>
int launch_pmxu(const void* image, const int* p, const int* c, int* out, int m, int tile,
                cudaStream_t s) {
  int dev, sms;
  int err = (int)cudaGetDevice(&dev);
  if (!err) err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (!err) {
    err = (int)cudaFuncSetAttribute(pmxu_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    kSmemBytes);
  }
  if (err) return err;
  int tiles = m / tile;
  int grid = tiles < sms ? tiles : sms;
  pmxu_kernel<T><<<grid, kThreads, kSmemBytes, s>>>(static_cast<const uint8_t*>(image), p, c,
                                                     out, m, tile);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: int8 0, bf16 1 (tools_cuda.MXU_DTYPES). image: the planes' shared-
// memory image (tools_cuda.mxu_image: 128 KB for int8, 256 KB for bf16,
// 16-byte aligned); p, c (null for a lookup of p itself), out: m int32; tile
// a positive multiple of 16 that divides m, m below 2**31 (checked by the
// wrapper). Returns the first nonzero CUDA error, or cudaErrorInvalidValue
// for another dtype or shape.
extern "C" int blt_pmxu(int dtype, const void* image, const void* p, const void* c, void* out,
                        int m, int tile, void* stream) {
  if (m <= 0 || tile <= 0 || tile % 16 || m % tile) return (int)cudaErrorInvalidValue;
  auto pp = (const int*)p;
  auto cc = (const int*)c;
  auto o = (int*)out;
  auto s = (cudaStream_t)stream;
  switch (dtype) {
    case kInt8: return launch_pmxu<kInt8>(image, pp, cc, o, m, tile, s);
    case kBf16: return launch_pmxu<kBf16>(image, pp, cc, o, m, tile, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
