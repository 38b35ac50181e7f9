// The copy floor of the token pass's ablation (T4's copy): out = tok.
//
// Replaces: tools/exp_mp_ablate.py::_one_call (kernel body from
// make_variant_kernel("copy")). T4's other four variants are flag sets of
// the merge round, blt_token_pass (token_pass.cu).
//
// Bound on the H100: the bytes, 4 in and 4 out per token (64 MiB at 8 Mi
// tokens, about 20 us at 3.35 TB/s).
//
// Design: 16 bytes per thread per step in a grid-stride loop sized to the
// card, as chain.cu does.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    copy_tokens(const int4* __restrict__ src, int4* __restrict__ dst, int nvec) {
  int stride = gridDim.x * blockDim.x;
  for (int v = blockIdx.x * blockDim.x + threadIdx.x; v < nvec; v += stride) {
    dst[v] = src[v];
  }
}

}  // namespace

// tokens, out: cap int32 (16-byte aligned, cap a multiple of 16, checked by
// the wrapper). Returns cudaGetLastError() after the launch.
extern "C" int blt_copy_tokens(const void* tokens, int cap, void* out,
                               void* stream) {
  int nvec = cap / 4;
  int want = (nvec + kThreads - 1) / kThreads;
  int blocks = want < 1 ? 1 : (want < 132 * 16 ? want : 132 * 16);
  copy_tokens<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int4*)tokens, (int4*)out, nvec);
  return (int)cudaGetLastError();
}
