// Basic-mode widen: byte b -> u16 value b << 8, whose little-endian memory
// image is the u16-BE wire pair [0x00, b] (reference tokenizer.rs:116-122).
//
// Replaces: blt_tpu/ops/bpe_pallas.py::basic_encode_pallas (kernel body
// _basic_kernel). The Pallas kernel's (1,1) completion token only forced
// completion through a remote TPU link and has no counterpart here.
//
// Bound on the H100: device memory. Every byte is read once and two bytes
// are written (3 bytes moved per input byte), with no arithmetic to speak of.
//
// Design: each thread loads 16 input bytes with one 16-byte load (uint4),
// widens them in registers with shifts and masks, and writes 32 output bytes
// with two 16-byte stores, so neighbouring threads touch neighbouring
// addresses. A grid-stride loop covers any length with a grid sized to the
// card; the ragged tail (n % 16 bytes) is widened byte by byte.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint4 widen_lo(uint32_t a, uint32_t b) {
  // bytes b0..b3 of a word -> words [0,b0,0,b1] and [0,b2,0,b3] (LSB first)
  return make_uint4(((a & 0xFFu) << 8) | ((a & 0xFF00u) << 16),
                    ((a >> 8) & 0xFF00u) | (a & 0xFF000000u),
                    ((b & 0xFFu) << 8) | ((b & 0xFF00u) << 16),
                    ((b >> 8) & 0xFF00u) | (b & 0xFF000000u));
}

__global__ void widen_kernel(const uint4* __restrict__ src,
                             uint4* __restrict__ dst, int64_t nvec,
                             const uint8_t* __restrict__ tail_src,
                             uint16_t* __restrict__ tail_dst, int tail) {
  int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t v = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; v < nvec;
       v += stride) {
    uint4 x = src[v];
    dst[2 * v] = widen_lo(x.x, x.y);
    dst[2 * v + 1] = widen_lo(x.z, x.w);
  }
  if (blockIdx.x == 0 && threadIdx.x < tail) {
    tail_dst[threadIdx.x] = (uint16_t)(tail_src[threadIdx.x] << 8);
  }
}

}  // namespace

// src: n bytes, dst: n u16; both 16-byte aligned (checked by the wrapper).
// Returns cudaGetLastError() after the launch.
extern "C" int blt_widen(const void* src, void* dst, int64_t n, void* stream) {
  if (n <= 0) return 0;
  int64_t nvec = n / 16;
  int tail = (int)(n % 16);
  int64_t want = (nvec + kThreads - 1) / kThreads;
  // enough blocks to fill 132 SMs several times over; the loop does the rest
  int blocks = (int)(want < 132 * 16 ? (want > 0 ? want : 1) : 132 * 16);
  widen_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint4*)src, (uint4*)dst, nvec,
      (const uint8_t*)src + nvec * 16, (uint16_t*)dst + nvec * 16, tail);
  return (int)cudaGetLastError();
}
