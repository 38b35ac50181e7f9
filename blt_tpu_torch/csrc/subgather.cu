// Row gather within each block of rows: the sublane-gather probe (T9).
//
// Replaces: tools/exp_parts.py::subgather (kernel body _subgather_kernel),
// `out = take_along_axis(tbl_block, idx_block, axis=0)` per rpb-row block.
//
// Per element (i, j) of a (rows, 128) int32 table and index array, in the
// block b = i / rpb that holds row i (the function of the Pallas kernel as
// interpret mode computes it, jnp.take_along_axis's "fill" mode):
//   0 <= x < rpb:   out[i, j] = tbl[b * rpb + x, j],      x = idx[i, j]
//   -rpb <= x < 0:  out[i, j] = tbl[b * rpb + x + rpb, j] (from the end)
//   otherwise:      out[i, j] = INT32_MIN
// and done = rows / rpb - 1, the Pallas grid's last step. No element reads
// outside its own block, whatever the index.
//
// Bound on the H100: the bytes, 4 read from idx and 4 written per element,
// and each table word the indices reach read once (192 MiB at the tool's 64
// MiB of indices over a 1024-row block, about 53 us at 3.35 TB/s; 128 MiB
// where the indices reach 8 rows). out[i, j] reads only column j of its own
// block, so a block's table is needed once, column slab by column slab.
//
// Design (slab path): one CTA per job, a job is one block of rpb rows x one
// slab of W columns. The CTA
//   1. stages the job's indices into shared memory (its tile), as 2D tensor
//      loads (cp.async.bulk.tensor through a CUtensorMap of idx, boxes of W
//      columns x kBoxRows rows) completing on an mbarrier, and takes the
//      block-wide min and max of the rows they reach, after the wrap from
//      the end;
//   2. stages only those rows of its slab of the table the same way (a map
//      of tbl, a second mbarrier): at index range 8 it reads 8 rows of the
//      block, at range rpb the slab once;
//   3. gathers each element from the slab in shared memory and stores it,
//      a warp writing 32 consecutive elements of the job (whole 32-byte
//      sectors of W / 8 rows).
// So every byte the function needs crosses the memory bus once, by TMA,
// with no registers held for it; threads touch only shared memory. The
// tile and slab take 2 * ceil(rpb / kBoxRows) * kBoxRows * W * 4 bytes:
// with W = 8 a 1024-row job takes 64 KiB, so three CTAs share an SM and
// one's staging runs under another's gather. The host halves W to 4 (16-byte
// rows, TMA's least) for blocks over 3616 rows; past 7232 the direct path
// runs. A row's W words sit in W consecutive banks, so a warp's gathers
// from 32 / W rows share a bank where their rows differ mod 32 / W (a
// 2-way conflict on average at W = 8); shared memory has bandwidth to
// spare. On an H100 (PERF.md) W = 8 beat 16 (one CTA per SM) by
// 15-25 % and 4 by a factor of two, and 128, 256 and 512 threads were
// within 2 % of each other except 128 at small ranges; staging only the
// table (32 columns, the indices read twice from memory) ran 1.13-1.20
// times slower. The maps are encoded on the host at each call (they hold the
// tensors' addresses) and passed as __grid_constant__ parameters.
// ops/tools_cuda.py::subgather_plan mirrors the width, the jobs and the
// shared memory for the CPU tests, which replay each job's staging.
//
// Blocks too tall for one SM's slab (a 16384-row slab of 8 columns is 512
// KiB against an SM's 227) take the direct path. A thread-block cluster
// holding the slab across its CTAs' shared memory, each element read from
// its owner by ld.shared::cluster, was exact but ran 0.30-0.45 ms in every
// shape at rpb 16384 on an H100 80GB HBM3 at 700 W (PERF.md, PR 14): a
// random 4-byte read of a peer's row costs more than the L2 read it saves.
//
// Direct path: a CTA takes kDirectUnroll x kDirectThreads consecutive
// 16-byte vectors (4 elements of a row each: one int4 of indices, four
// 4-byte gathers through the read-only cache, one int4 store), CTAs in
// launch order, so the rows in flight are a narrow band and the table of
// one or two blocks stays in L2 (the grid-stride loop it replaced spread
// every block's table over L2 at once: 0.288 ms at rpb 16384, 0.157-0.159
// now, level with torch.gather's 0.157-0.159, on the same card). The block of a CTA's
// first row is divided out once.

#include <atomic>
#include <climits>
#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

#include "bulk.cuh"

namespace {

constexpr int kLanes = 128;
constexpr int kThreads = 256;            // slab path
constexpr int kBoxRows = 32;            // rows per tensor load
constexpr int kSmemBytes = 226 * 1024;  // a job's tile and slab (1 KiB of 227 left)
constexpr int kDirectThreads = 256;
constexpr int kDirectUnroll = 2;        // int4 vectors a thread of the direct path (of 1-8, PERF.md)

// The row of the block that index x reaches, or -1 (the fill).
__device__ __forceinline__ int reach(int x, int rpb) {
  if (x < -rpb || x >= rpb) return -1;
  return x < 0 ? x + rpb : x;
}

// One thread: rows y .. y + rows - 1 (whole boxes from y) of a W-column
// slab at column x of `map` into shared memory at dst, completing on bar.
template <int W>
__device__ __forceinline__ void stage_rows(uint32_t dst, const CUtensorMap* map, int x, int y,
                                           int rows, uint32_t bar) {
  const int boxes = (rows + kBoxRows - 1) / kBoxRows;
  expect_bytes(bar, (uint32_t)(boxes * kBoxRows * W * 4));
  for (int b = 0; b < boxes; ++b) {
    tensor_load_2d(dst + (uint32_t)(b * kBoxRows * W * 4), map, x, y + b * kBoxRows, bar);
  }
}

template <int W>
__global__ void __launch_bounds__(kThreads)
    subgather_slab_kernel(const __grid_constant__ CUtensorMap tbl_map,
                          const __grid_constant__ CUtensorMap idx_map, int* __restrict__ out,
                          int rpb, int* __restrict__ done, int last_step) {
  extern __shared__ __align__(128) int smem[];  // the tile, then the slab
  __shared__ __align__(8) uint64_t bars[2];
  __shared__ int warp_lo[kThreads / 32], warp_hi[kThreads / 32];
  constexpr int kSlabs = kLanes / W;
  const int block = blockIdx.x / kSlabs;
  const int col0 = (blockIdx.x % kSlabs) * W;
  const int row0 = block * rpb;
  const int elems = rpb * W;
  const int staged_rows = (rpb + kBoxRows - 1) / kBoxRows * kBoxRows;
  int* tile = smem;
  int* slab = smem + staged_rows * W;
  const uint32_t idx_bar = (uint32_t)__cvta_generic_to_shared(&bars[0]);
  const uint32_t slab_bar = (uint32_t)__cvta_generic_to_shared(&bars[1]);
  if (threadIdx.x == 0) {
    mbar_init(idx_bar);
    mbar_init(slab_bar);
    stage_rows<W>((uint32_t)__cvta_generic_to_shared(tile), &idx_map, col0, row0, rpb,
                  idx_bar);
  }
  __syncthreads();  // the barriers' init
  mbar_wait(idx_bar, 0);

  // 1. the rows of the block the job's indices reach
  int lo = INT_MAX, hi = -1;
  for (int e = threadIdx.x; e < elems; e += kThreads) {
    const int r = reach(tile[e], rpb);
    if (r >= 0) {
      lo = min(lo, r);
      hi = max(hi, r);
    }
  }
  lo = __reduce_min_sync(0xffffffffu, lo);
  hi = __reduce_max_sync(0xffffffffu, hi);
  if ((threadIdx.x & 31) == 0) {
    warp_lo[threadIdx.x >> 5] = lo;
    warp_hi[threadIdx.x >> 5] = hi;
  }
  __syncthreads();
  lo = INT_MAX;
  hi = -1;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) {
    lo = min(lo, warp_lo[w]);
    hi = max(hi, warp_hi[w]);
  }

  // 2. stage rows lo..hi of the slab (the last box may run past hi)
  if (hi >= 0) {
    if (threadIdx.x == 0) {
      stage_rows<W>((uint32_t)__cvta_generic_to_shared(slab), &tbl_map, col0, row0 + lo,
                    hi - lo + 1, slab_bar);
    }
    mbar_wait(slab_bar, 0);
  }

  // 3. gather from the slab
  int* dst = out + (int64_t)row0 * kLanes + col0;
#pragma unroll 4
  for (int e = threadIdx.x; e < elems; e += kThreads) {
    const int r = reach(tile[e], rpb);
    dst[(e / W) * kLanes + e % W] = r >= 0 ? slab[(r - lo) * W + e % W] : INT_MIN;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) done[0] = last_step;
}

__device__ __forceinline__ int gather_one(const int* __restrict__ tbl,
                                          int64_t block_row, int rpb, int x,
                                          int col) {
  const int r = reach(x, rpb);
  return r < 0 ? INT_MIN : __ldg(tbl + (block_row + r) * kLanes + col);
}

// A CTA a span of kDirectUnroll * kDirectThreads consecutive vectors,
// launched in order: the rows in flight at once are a band of a few
// thousand, so the table of one or two blocks stays in L2. The block of the
// span's first row is divided out once; the span's 16 rows cross a block's
// end at most once where rpb >= 16.
__global__ void __launch_bounds__(kDirectThreads)
    subgather_direct_kernel(const int* __restrict__ tbl, const int4* __restrict__ idx,
                            int4* __restrict__ out, int64_t nvec, int rpb,
                            int* __restrict__ done, int last_step) {
  constexpr int kSpan = kDirectUnroll * kDirectThreads;  // vectors a CTA
  const int64_t v0 = (int64_t)blockIdx.x * kSpan + threadIdx.x;
  const int64_t first_row = (int64_t)blockIdx.x * kSpan * 4 / kLanes;
  const int64_t block_row = first_row / rpb * rpb;
  int4 x[kDirectUnroll];
#pragma unroll
  for (int u = 0; u < kDirectUnroll; ++u) {
    const int64_t v = v0 + u * kDirectThreads;
    x[u] = v < nvec ? __ldg(idx + v) : make_int4(0, 0, 0, 0);
  }
#pragma unroll
  for (int u = 0; u < kDirectUnroll; ++u) {
    const int64_t v = v0 + u * kDirectThreads;
    if (v >= nvec) break;
    const int64_t row = v * 4 / kLanes;
    int64_t b = block_row;
    while (row >= b + rpb) b += rpb;
    const int col = (int)(v * 4 % kLanes);
    const int4 y = make_int4(gather_one(tbl, b, rpb, x[u].x, col),
                             gather_one(tbl, b, rpb, x[u].y, col + 1),
                             gather_one(tbl, b, rpb, x[u].z, col + 2),
                             gather_one(tbl, b, rpb, x[u].w, col + 3));
    out[v] = y;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) done[0] = last_step;
}

// cuTensorMapEncodeTiled, looked up through the CUDA runtime (no link
// against libcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static std::atomic<EncodeTiled> fn{nullptr};
  EncodeTiled f = fn.load();
  if (f) return f;
  void* p = nullptr;
  cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
  cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                     cudaEnableDefault, &q);
#else
  cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
  if (err != cudaSuccess || q != cudaDriverEntryPointSuccess) return nullptr;
  f = reinterpret_cast<EncodeTiled>(p);
  fn.store(f);
  return f;
}

// A map of a rows x 128 int32 tensor in boxes of w columns x kBoxRows rows;
// false where cuTensorMapEncodeTiled refuses it.
bool encode_map(EncodeTiled encode, CUtensorMap* map, const int* base, int64_t rows, int w) {
  const cuuint64_t dims[2] = {kLanes, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {kLanes * sizeof(int)};
  const cuuint32_t box[2] = {(cuuint32_t)w, kBoxRows};
  const cuuint32_t elem_strides[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_INT32, 2, const_cast<int*>(base), dims, strides,
                box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The slab kernel of width W: opted into kSmemBytes once per device (the
// attribute holds for the device current when it is set), then launched.
template <int W>
int launch_slab(const int* tbl, const int* idx, int* out, int64_t rows, int rpb, int* done,
                cudaStream_t s) {
  const int smem = 2 * ((rpb + kBoxRows - 1) / kBoxRows * kBoxRows) * W * 4;
  if (smem > kSmemBytes || rows > INT_MAX) return (int)cudaErrorInvalidValue;
  static std::atomic<uint64_t> allowed{0};
  int dev;
  int err = (int)cudaGetDevice(&dev);
  if (err) return err;
  const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
  if (!(allowed.load() & bit)) {
    err = (int)cudaFuncSetAttribute(subgather_slab_kernel<W>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err) return err;
    allowed.fetch_or(bit);
  }
  EncodeTiled encode = encode_tiled();
  if (!encode) return (int)cudaErrorNotSupported;
  CUtensorMap tbl_map, idx_map;
  if (!encode_map(encode, &tbl_map, tbl, rows, W) || !encode_map(encode, &idx_map, idx, rows, W)) {
    return (int)cudaErrorInvalidValue;
  }
  const int64_t jobs = rows / rpb * (kLanes / W);
  if (jobs > INT_MAX) return (int)cudaErrorInvalidValue;
  subgather_slab_kernel<W><<<(int)jobs, kThreads, smem, s>>>(tbl_map, idx_map, out, rpb, done,
                                                            (int)(rows / rpb - 1));
  return (int)cudaGetLastError();
}

}  // namespace

// tbl, idx, out: rows x 128 int32 each (16-byte aligned, rows a positive
// multiple of rpb, checked by the wrapper); done: one int32. width: the
// slab's columns (8 or 4; tools_cuda.subgather_plan's), or 0 for the
// direct path. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a width whose job does not fit.
extern "C" int blt_subgather(const void* tbl, const void* idx, void* out, int64_t rows,
                             int rpb, int width, void* done, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int* t = (const int*)tbl;
  const int* x = (const int*)idx;
  int* o = (int*)out;
  int* d = (int*)done;
  switch (width) {
    case 8: return launch_slab<8>(t, x, o, rows, rpb, d, s);
    case 4: return launch_slab<4>(t, x, o, rows, rpb, d, s);
    case 0: break;
    default: return (int)cudaErrorInvalidValue;
  }
  const int64_t nvec = rows * kLanes / 4;
  const int64_t blocks = (nvec + kDirectUnroll * kDirectThreads - 1) /
                         (kDirectUnroll * kDirectThreads);
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  subgather_direct_kernel<<<(int)blocks, kDirectThreads, 0, s>>>(
      t, (const int4*)x, (int4*)o, nvec, rpb, d, (int)(rows / rpb - 1));
  return (int)cudaGetLastError();
}
