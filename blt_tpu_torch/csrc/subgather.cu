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
// Bound on the H100: the bytes, 4 read from idx, 4 gathered from tbl and 4
// written per element (192 MiB at the tool's 64 MiB of indices, about 60 us
// at 3.35 TB/s). A block of 1024 rows is 512 KB of table, more than an SM's
// shared memory, so the gathered rows come through L1 and L2 (50 MB).
//
// Design: each thread takes 4 consecutive elements of a row per step (one
// int4 of indices, four 4-byte gathers, one int4 store), neighbouring
// threads on neighbouring columns, in a grid-stride loop sized to the card.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 128;

__device__ __forceinline__ int gather_one(const int* __restrict__ tbl,
                                          int64_t block_row, int rpb, int x,
                                          int col) {
  if (x < -rpb || x >= rpb) return INT_MIN;
  int row = x < 0 ? x + rpb : x;
  return __ldg(tbl + (block_row + row) * kLanes + col);
}

__global__ void __launch_bounds__(kThreads)
    subgather_kernel(const int* __restrict__ tbl, const int4* __restrict__ idx,
                     int4* __restrict__ out, int64_t nvec, int rpb,
                     int* __restrict__ done, int last_step) {
  int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t v = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; v < nvec;
       v += stride) {
    int64_t e = 4 * v;
    int64_t row = e / kLanes;
    int col = (int)(e % kLanes);
    int64_t block_row = row - row % rpb;
    int4 x = idx[v];
    out[v] = make_int4(gather_one(tbl, block_row, rpb, x.x, col),
                       gather_one(tbl, block_row, rpb, x.y, col + 1),
                       gather_one(tbl, block_row, rpb, x.z, col + 2),
                       gather_one(tbl, block_row, rpb, x.w, col + 3));
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) done[0] = last_step;
}

}  // namespace

// tbl, idx, out: rows x 128 int32 each (16-byte aligned, rows a positive
// multiple of rpb, checked by the wrapper); done: one int32. Returns
// cudaGetLastError() after the launch.
extern "C" int blt_subgather(const void* tbl, const void* idx, void* out,
                             int64_t rows, int rpb, void* done, void* stream) {
  int64_t nvec = rows * kLanes / 4;
  int64_t want = (nvec + kThreads - 1) / kThreads;
  int blocks = (int)(want < 132 * 16 ? want : 132 * 16);
  subgather_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)tbl, (const int4*)idx, (int4*)out, nvec, rpb, (int*)done,
      (int)(rows / rpb - 1));
  return (int)cudaGetLastError();
}
