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
// One kernel template, lookup_kernel<V>, serves every variant; the variant
// fixes the read (lookup_one) and the bytes it stages (kStaged):
//   chain, g2d: one shared-memory read an element, the word t[q >> 1], then
//     its half. The original's body_chain is a 256-segment select chain
//     (read segment s at lane h & 127, keep it where s == h >> 7): the TPU's
//     way round a missing dynamic gather, not part of the function (256
//     shared-memory reads an element when carried over as written: 0.55 ms
//     at 131072 rows on an H100 80GB HBM3 at 700 W, PERF.md); body_g2d is
//     the same read as a dynamic gather. On Hopper the two designs coincide,
//     so g2d runs chain's instantiation, under its own counter and row;
//   gax0: one shared-memory read of the word at row q >> 8, lane (4g + j) &
//     127 for element j of group g;
//   g8bit: one shared-memory byte read, tbl8[q & 4095];
//   g2d_flat: the word read from the table in device memory through the
//     read-only data cache (__ldg), the flattened jnp.take: stages nothing,
//     so the tool still sets a staged read beside an unstaged one.
// The design (the production chain lookup's, made a template):
//   - staging: one thread stages the table (128 KiB packed, 4 KiB tbl8)
//     with bulk asynchronous copies (cp.async.bulk, bulk.cuh's stage:
//     kPiece-byte pieces on one mbarrier); every thread issues its first p
//     and c loads before it waits for the table, so the staging overlaps
//     them;
//   - loads in flight: a thread takes kUnroll = 4 groups of 4 elements a
//     step (16-byte loads and stores), their p and c loaded together: 8
//     16-byte loads in flight a thread, 4 without c. A group's table reads
//     come just before its store (in the SASS too: g2d_flat's four __ldg,
//     then its STG.128). Holding all four groups' results until every read
//     was issued took 64 registers with spills, against 56-58, and bought
//     nothing: g2d_flat 0.0048-0.0049 ms against 0.0048-0.0050 at 4096
//     rows, 0.0743-0.0747 against 0.0723-0.0733 at 131072, the staged
//     variants up to 10 % slower at 4096 rows (PERF.md);
//   - grid sized to the work: ceil(n / per_cta) CTAs of 1024 threads, at
//     most as many as the SMs hold at once (the occupancy query: one an SM
//     for every variant, by the 128 KiB tables and by registers). Every CTA
//     stages the whole table (p is random over it), from L2 and behind its
//     first loads. per_cta (kPackedPerCta, kTbl8PerCta, kFlatPerCta) was
//     set by one sweep of 4, 8 and 16 Ki elements a CTA, chained 16 on an
//     H100 80GB HBM3 at 700 W (PERF.md). At 4096 rows chain, g2d, gax0,
//     g8bit and g2d_flat took 0.0039, 0.0039, 0.0040, 0.0029 and 0.0056 ms
//     at 4 Ki; 0.0041, 0.0041, 0.0042, 0.0032 and 0.0051 at 8 Ki; 0.0049,
//     0.0048, 0.0051, 0.0044 and 0.0068 at 16 Ki. At 131072 rows every
//     choice took 0.0683-0.0728. So the staged variants take 4 Ki (128 CTAs
//     at 4096 rows), g2d_flat, which stages nothing, 8 Ki. One rule a
//     variant at every size, no second path. Chained 16 at 8 rows (one CTA),
//     a launch takes 0.0020-0.0027 ms (chain 0.0024): the floor under a
//     small call, which chain's 0.0038-0.0040 at 4096 rows sits 1.5 us
//     above.
//
// Bound on the H100: the bytes. A link reads p and c and writes out, 12
// bytes per element, plus the table once (128 KB): 192 MiB at 16 Mi
// elements, about 60 us at 3.35 TB/s; at the tool's 512 Ki elements 6 MiB,
// about 2 us, so launch-bound.

#include <cstdint>
#include <cuda_runtime.h>

#include "bulk.cuh"

namespace {

enum Lookup : int { kChain = 0, kG2d = 1, kG2dFlat = 2, kGax0 = 3, kG8bit = 4 };

constexpr int kLookupThreads = 1024;
constexpr int kPackedBytes = 256 * 128 * 4;  // the packed table, 128 KiB
constexpr int kTbl8Bytes = 32 * 128;         // g8bit's u8 table, 4 KiB
constexpr uint32_t kPiece = 16 * 1024;       // bytes of one bulk copy of a table
constexpr int kUnroll = 4;                   // groups of 4 a thread takes a step
// elements a CTA takes at least: the variants staging the packed table,
// g8bit, and g2d_flat (the sweep in the header)
constexpr int kPackedPerCta = 4 * 1024;
constexpr int kTbl8PerCta = 4 * 1024;
constexpr int kFlatPerCta = 8 * 1024;
static_assert(kPackedBytes % kPiece == 0, "the packed table is whole pieces");

// table bytes a CTA of variant V stages, and the elements it takes at least
template <int V>
constexpr int kStaged = V == kG2dFlat ? 0 : V == kG8bit ? kTbl8Bytes : kPackedBytes;
template <int V>
constexpr int kPerCta = V == kG2dFlat ? kFlatPerCta : V == kG8bit ? kTbl8PerCta : kPackedPerCta;

__device__ __forceinline__ int unpack(int w, int q) {
  return (q & 1) ? (w >> 16) & 0xFFFF : w & 0xFFFF;
}

// Element q's value: t is the staged table, or for g2d_flat the table in
// device memory; lane is the element's own column.
template <int V>
__device__ __forceinline__ int lookup_one(const int* __restrict__ t, int q, int lane) {
  if constexpr (V == kG2dFlat) {
    return unpack(__ldg(t + (q >> 1)), q);
  } else if constexpr (V == kGax0) {
    return t[(q >> 8) * 128 + lane];
  } else if constexpr (V == kG8bit) {
    return reinterpret_cast<const uint8_t*>(t)[q & 4095];
  } else {
    return unpack(t[q >> 1], q);
  }
}

// The 16-bit inputs of one group of 4: p & 0xFFFF, or with c the link's
// (p + (c & 1)) & 0xFFFF.
__device__ __forceinline__ int4 link_q(int4 p, const int4* c) {
  if (c) {
    return make_int4((p.x + (c->x & 1)) & 0xFFFF, (p.y + (c->y & 1)) & 0xFFFF,
                     (p.z + (c->z & 1)) & 0xFFFF, (p.w + (c->w & 1)) & 0xFFFF);
  }
  return make_int4(p.x & 0xFFFF, p.y & 0xFFFF, p.z & 0xFFFF, p.w & 0xFFFF);
}

// One step's inputs of a thread: kUnroll groups of p (and c).
struct Step {
  int4 p[kUnroll];
  int4 c[kUnroll];
};

__device__ __forceinline__ void load_step(Step& s, const int4* __restrict__ p,
                                          const int4* __restrict__ c, int g, int stride,
                                          int groups) {
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int gu = g + u * stride;
    if (gu < groups) {
      s.p[u] = p[gu];
      if (c) s.c[u] = c[gu];
    }
  }
}

template <int V>
__global__ void __launch_bounds__(kLookupThreads)
    lookup_kernel(const int* __restrict__ tbl, const int4* __restrict__ p,
                  const int4* __restrict__ c, int4* __restrict__ out, int groups) {
  extern __shared__ __align__(128) int table[];
  __shared__ __align__(8) uint64_t bar;
  const uint32_t bar_addr = (uint32_t)__cvta_generic_to_shared(&bar);
  if constexpr (kStaged<V> > 0) {
    if (threadIdx.x == 0) {
      mbar_init(bar_addr);
      stage((uint32_t)__cvta_generic_to_shared(table), reinterpret_cast<const uint8_t*>(tbl),
            kStaged<V>, kPiece, bar_addr);
    }
  }
  const int stride = gridDim.x * blockDim.x;
  int g = blockIdx.x * blockDim.x + threadIdx.x;
  Step cur;
  load_step(cur, p, c, g, stride, groups);  // in flight while the table arrives
  const int* t = tbl;
  if constexpr (kStaged<V> > 0) {
    __syncthreads();  // the barrier's initialisation
    mbar_wait(bar_addr, 0);
    t = table;
  }
  while (g < groups) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int gu = g + u * stride;
      if (gu < groups) {
        const int4 q = link_q(cur.p[u], c ? &cur.c[u] : nullptr);
        const int lane = (4 * gu) & 127;
        out[gu] = make_int4(lookup_one<V>(t, q.x, lane), lookup_one<V>(t, q.y, lane + 1),
                            lookup_one<V>(t, q.z, lane + 2), lookup_one<V>(t, q.w, lane + 3));
      }
    }
    g += kUnroll * stride;
    load_step(cur, p, c, g, stride, groups);
  }
}

// CTAs of lookup_kernel<V> that one SM of the current device holds at once,
// with its staged bytes of dynamic shared memory.
template <int V>
int ctas_per_sm(int* ctas) {
  int err = (int)cudaFuncSetAttribute(lookup_kernel<V>,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize, kStaged<V>);
  if (err) return err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, lookup_kernel<V>,
                                                            kLookupThreads, kStaged<V>);
}

template <int V>
int launch_lookup(const int* tbl, const int* p, const int* c, int* out, int n,
                  cudaStream_t s) {
  int dev, sms, per_sm;
  int err = (int)cudaGetDevice(&dev);
  if (!err) err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (!err) err = ctas_per_sm<V>(&per_sm);
  if (err) return err;
  const int want = (n + kPerCta<V> - 1) / kPerCta<V>;
  const int cap = per_sm * sms;
  const int grid = want < 1 ? 1 : (want < cap ? want : cap);
  lookup_kernel<V><<<grid, kLookupThreads, kStaged<V>, s>>>(
      tbl, reinterpret_cast<const int4*>(p), reinterpret_cast<const int4*>(c),
      reinterpret_cast<int4*>(out), n / 4);
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
    case kChain:
    case kG2d: return launch_lookup<kChain>(t, pp, cc, o, n, s);
    case kG2dFlat: return launch_lookup<kG2dFlat>(t, pp, cc, o, n, s);
    case kGax0: return launch_lookup<kGax0>(t, pp, cc, o, n, s);
    case kG8bit: return launch_lookup<kG8bit>(t, pp, cc, o, n, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// CTAs of each instantiation that one SM of the current device holds at
// once, as the CUDA runtime computes them from the compiled kernel and its
// staged bytes (chain's serves g2d). Each returns the first nonzero CUDA
// error.
extern "C" int blt_lookup_chain_ctas_per_sm(int* ctas) { return ctas_per_sm<kChain>(ctas); }
extern "C" int blt_lookup_g2d_flat_ctas_per_sm(int* ctas) { return ctas_per_sm<kG2dFlat>(ctas); }
extern "C" int blt_lookup_gax0_ctas_per_sm(int* ctas) { return ctas_per_sm<kGax0>(ctas); }
extern "C" int blt_lookup_g8bit_ctas_per_sm(int* ctas) { return ctas_per_sm<kG8bit>(ctas); }
