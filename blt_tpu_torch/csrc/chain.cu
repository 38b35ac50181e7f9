// Byte copy and widen with a completion token, launched k times back to
// back on one stream: the device-rate kernels.
//
// Replaces:
//   K5 blt_tpu/ops/bpe_pallas.py::basic_encode_chained (body
//      _basic_chained_kernel): widen chained through a token;
//   T1 tools/exp_chain.py::_call (bodies _copy_kernel, _widen_kernel):
//      copy or widen chained through a token (copy_chain, widen_chain);
//   T7 tools/exp_sweep.py::copy_pallas (body _copy_kernel): a raw u8 copy
//      whose "done" value is its last grid step.
// Per launch, over rows x 128 bytes: copy writes dst = src (u8), widen
// writes dst = src << 8 (u16, the LE image of the u16-BE wire). The token
// is what the Pallas grid's last step writes: tok_in + (rows / rpb - 1),
// or rows / rpb - 1 where there is no token input (T7). The wrapper passes
// that addend. The Pallas kernel writes it at every grid step and the last
// step wins; here one thread writes it once.
//
// Bound on the H100: device memory. Copy moves 2 bytes per input byte,
// widen 3; there is no arithmetic to speak of.
//
// Design: as widen.cu, each thread moves 16 input bytes per step with one
// 16-byte load (and one or two 16-byte stores), neighbouring threads on
// neighbouring addresses, in a grid-stride loop. rows * 128 is a multiple
// of 16, so there is no ragged tail. The block count is the caller's: 0
// sizes the grid to the card (132 SMs x 16 blocks); the sweep passes
// rows / rpb, the Pallas grid. A chain of k launches alternates two token
// buffers, so no launch reads the token it writes.

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

template <bool kWiden>
__global__ void __launch_bounds__(kThreads)
    chain_kernel(const uint4* __restrict__ src, uint4* __restrict__ dst,
                 int64_t nvec, const int* __restrict__ tok_in,
                 int* __restrict__ tok_out, int add) {
  int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t v = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; v < nvec;
       v += stride) {
    uint4 x = src[v];
    if (kWiden) {
      dst[2 * v] = widen_lo(x.x, x.y);
      dst[2 * v + 1] = widen_lo(x.z, x.w);
    } else {
      dst[v] = x;
    }
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    tok_out[0] = (tok_in != nullptr ? tok_in[0] : 0) + add;
  }
}

}  // namespace

// widen: 0 copy, 1 widen. src: n bytes (n a multiple of 16), dst: n bytes
// or n u16, both 16-byte aligned (checked by the wrapper). tok_in: one
// int32 or NULL; tok_a, tok_b: one int32 each. Launch j reads tok_in (j = 0,
// or every launch when tok_in is NULL) or the token launch j - 1 wrote, and
// writes tok_a (j even) or tok_b (j odd). blocks: 0 sizes the grid to the
// card. Returns the first nonzero cudaGetLastError() of the launches.
extern "C" int blt_chain(int widen, const void* src, void* dst, int64_t n,
                         const void* tok_in, void* tok_a, void* tok_b, int add,
                         int k, int blocks, void* stream) {
  if (n <= 0 || k <= 0) return 0;
  int64_t nvec = n / 16;
  if (blocks <= 0) {
    int64_t want = (nvec + kThreads - 1) / kThreads;
    blocks = (int)(want < 132 * 16 ? want : 132 * 16);
  }
  cudaStream_t s = (cudaStream_t)stream;
  const int* in = (const int*)tok_in;
  for (int j = 0; j < k; ++j) {
    int* out = (int*)((j & 1) ? tok_b : tok_a);
    if (widen) {
      chain_kernel<true><<<blocks, kThreads, 0, s>>>(
          (const uint4*)src, (uint4*)dst, nvec, in, out, add);
    } else {
      chain_kernel<false><<<blocks, kThreads, 0, s>>>(
          (const uint4*)src, (uint4*)dst, nvec, in, out, add);
    }
    int err = (int)cudaGetLastError();
    if (err) return err;
    if (tok_in != nullptr) in = out;
  }
  return 0;
}
