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
// chain is the Hopper design of the original's production lookup
// (chain_kernel below). The original's body_chain is a 256-segment select
// chain (read segment s at lane h & 127, keep it where s == h >> 7): the
// TPU's way round a missing dynamic gather, not part of the function: 256
// shared-memory reads an element when carried over as written (0.55 ms at
// 131072 rows on an H100 80GB HBM3 at 700 W, PERF.md). chain_kernel:
//   - one shared-memory read an element: the word t[q >> 1], then its half;
//   - the 128 KiB table staged by one thread with bulk asynchronous copies
//     (cp.async.bulk, bulk.cuh's stage: kPiece-byte pieces on one
//     mbarrier); every thread issues its first p and c loads before it
//     waits for the table, so the staging overlaps them;
//   - loads in flight: a thread takes kUnroll = 4 groups of 4 elements a
//     step (16-byte loads and stores), their p and c loaded together: 8
//     16-byte loads in flight a thread, 4 without c, 128 KiB an SM;
//   - grid sized to the work: ceil(n / kChainPerCta) CTAs of 1024 threads,
//     at most one per SM (the table fills 128 KiB of shared memory), with
//     kChainPerCta = 8 Ki elements: 64 CTAs at the tool's 4096 rows, one
//     per SM at 131072. Every CTA stages the whole table (p is random over
//     it), but from L2 and behind its first loads: what bounds a small call
//     is the loads in flight, not the staging. So a CTA takes a quarter as
//     many elements as the words it stages, not more: on an H100 80GB HBM3
//     at 700 W, chained 16 at 4096 rows, 4 Ki elements a CTA took 0.0040
//     ms, 8 Ki 0.0042, 16 Ki 0.0050, 32 Ki 0.0071, and 128 Ki (four times
//     the staged words, 4 CTAs) 0.0192; at 131072 rows every choice took
//     0.0700-0.0714 (PERF.md). One rule at every size, no second path.
//   Chained 16 on that card: 0.0688-0.0713 ms at 131072 rows against the
//   bytes' 0.0601 and torch.take's 0.105-0.110; 0.0038-0.0043 at 4096 rows
//   against 0.0019 and 0.0063-0.0066.
// The other four are the tool's other designs, each a probe timed beside
// chain (lookup_kernel):
//   g2d_flat: the word read from the table in device memory through the
//     read-only data cache (__ldg), the flattened jnp.take;
//   g2d: the table staged in 128 KB of dynamic shared memory by a loop of
//     int4 copies, on a persistent grid of one block per SM;
//   gax0, g8bit: from the staged table, as probes against their own
//     references.
// Each thread takes 4 consecutive elements per step (16-byte loads and
// stores) in a grid-stride loop.
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
constexpr int kPackedWords = 256 * 128;
constexpr int kTbl8Words = 32 * 128 / 4;
constexpr int kChainPerCta = 8 * 1024;  // elements a chain CTA takes at least
constexpr uint32_t kPiece = 16 * 1024;  // bytes of one bulk copy of the table
constexpr int kTableBytes = kPackedWords * 4;
constexpr int kUnroll = 4;              // groups of 4 a chain thread takes a step
static_assert(kTableBytes % kPiece == 0, "the table is whole pieces");

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
  } else if constexpr (V == kGax0) {
    return t[(q >> 8) * 128 + lane];
  } else {
    return reinterpret_cast<const uint8_t*>(t)[q & 4095];
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
    int4 cv;
    if (c) cv = reinterpret_cast<const int4*>(c)[g];
    int4 q = link_q(reinterpret_cast<const int4*>(p)[g], c ? &cv : nullptr);
    int r[4] = {lookup_one<V>(t, q.x, (4 * g) & 127), lookup_one<V>(t, q.y, (4 * g + 1) & 127),
                lookup_one<V>(t, q.z, (4 * g + 2) & 127), lookup_one<V>(t, q.w, (4 * g + 3) & 127)};
    reinterpret_cast<int4*>(out)[g] = make_int4(r[0], r[1], r[2], r[3]);
  }
}

// One step's inputs of a chain thread: kUnroll groups of p (and c).
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

__global__ void __launch_bounds__(kLookupThreads)
    chain_kernel(const int* __restrict__ tbl, const int* __restrict__ p,
                 const int* __restrict__ c, int* __restrict__ out, int groups) {
  extern __shared__ __align__(128) int table[];
  __shared__ __align__(8) uint64_t bar;
  const uint32_t bar_addr = (uint32_t)__cvta_generic_to_shared(&bar);
  if (threadIdx.x == 0) {
    mbar_init(bar_addr);
    stage((uint32_t)__cvta_generic_to_shared(table), reinterpret_cast<const uint8_t*>(tbl),
          kTableBytes, kPiece, bar_addr);
  }
  const int stride = gridDim.x * blockDim.x;
  const int4* p4 = reinterpret_cast<const int4*>(p);
  const int4* c4 = reinterpret_cast<const int4*>(c);
  int g = blockIdx.x * blockDim.x + threadIdx.x;
  Step cur;
  load_step(cur, p4, c4, g, stride, groups);  // in flight while the table arrives
  __syncthreads();                            // the barrier's initialisation
  mbar_wait(bar_addr, 0);
  while (g < groups) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int gu = g + u * stride;
      if (gu < groups) {
        const int4 q = link_q(cur.p[u], c ? &cur.c[u] : nullptr);
        reinterpret_cast<int4*>(out)[gu] =
            make_int4(unpack(table[q.x >> 1], q.x), unpack(table[q.y >> 1], q.y),
                      unpack(table[q.z >> 1], q.z), unpack(table[q.w >> 1], q.w));
      }
    }
    g += kUnroll * stride;
    load_step(cur, p4, c4, g, stride, groups);
  }
}

int sm_count(int* sms) {
  int dev;
  int err = (int)cudaGetDevice(&dev);
  if (!err) err = (int)cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return err;
}

int launch_chain(const int* tbl, const int* p, const int* c, int* out, int n, cudaStream_t s) {
  int sms;
  int err = sm_count(&sms);
  if (!err) {
    err = (int)cudaFuncSetAttribute(chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    kTableBytes);
  }
  if (err) return err;
  const int want = (n + kChainPerCta - 1) / kChainPerCta;
  const int grid = want < 1 ? 1 : (want < sms ? want : sms);
  chain_kernel<<<grid, kLookupThreads, kTableBytes, s>>>(tbl, p, c, out, n / 4);
  return (int)cudaGetLastError();
}

template <int V>
int launch_lookup(const int* tbl, const int* p, const int* c, int* out, int n,
                  cudaStream_t s) {
  constexpr bool kStaged = V != kG2dFlat;
  size_t smem = kStaged ? (V == kG8bit ? kTbl8Words : kPackedWords) * sizeof(int) : 0;
  int groups = n / 4;
  int want = (groups + kLookupThreads - 1) / kLookupThreads;
  int sms;
  int err = sm_count(&sms);
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
    case kChain: return launch_chain(t, pp, cc, o, n, s);
    case kG2d: return launch_lookup<kG2d>(t, pp, cc, o, n, s);
    case kG2dFlat: return launch_lookup<kG2dFlat>(t, pp, cc, o, n, s);
    case kGax0: return launch_lookup<kGax0>(t, pp, cc, o, n, s);
    case kG8bit: return launch_lookup<kG8bit>(t, pp, cc, o, n, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// CTAs of chain_kernel that one SM of the current device holds at once, as
// the CUDA runtime computes them from the compiled kernel and its 128 KiB
// of shared memory. Returns the first nonzero CUDA error.
extern "C" int blt_lookup_chain_ctas_per_sm(int* ctas) {
  int err = (int)cudaFuncSetAttribute(chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      kTableBytes);
  if (err) return err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, chain_kernel, kLookupThreads,
                                                            kTableBytes);
}
