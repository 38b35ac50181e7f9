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
// Bound on the H100: device memory. Copy moves 2 bytes per input byte (one
// read, one write), widen 3; there is no arithmetic to speak of. At 64 MiB
// the copy's bound is 128 MiB over 3.35 TB/s, 0.0401 ms.
//
// Copy (T1 copy, T7): each block streams one contiguous span of the input
// through a ring of kStages stages of kStageBytes in dynamic shared memory,
// with Hopper's bulk asynchronous copies (bulk.cuh). One thread runs the
// ring: it keeps a load in flight into every stage (cp.async.bulk global ->
// shared, completing on the stage's mbarrier, whose parity flips on each
// reuse); when a stage's load completes it stores the stage (cp.async.bulk
// shared -> global in a bulk group); a stage is reloaded only after
// cp.async.bulk.wait_group.read has seen its store read it, and the block
// waits for all its stores before it exits. Nothing in the generic proxy
// touches the ring, so no proxy fence sits between a load and its store.
// Threads spend no registers on the bytes: what is in flight is the ring's,
// not threads x unrolling. Every address and size is a multiple of 16, as
// bulk copies need (the last stage of a span may be shorter than a stage).
// A ring never has more stages than its span has stage-sized pieces, so a
// short span takes less shared memory and more blocks fit on an SM.
//
// T7 keeps one block per Pallas grid step (rows / rpb; its span is the
// step's rpb x 128 bytes: 64 KiB, 256 KiB, 1 MiB at the sweep's 512, 2048,
// 8192), so its sweep asks how few blocks hold the copy floor. On an H100
// an SM moves about 20 GB/s each way with rings of 64 KiB to 192 KiB alike:
// at rpb 8192, 64 blocks on 64 of the 132 SMs, the copy takes 1.11-1.16
// times clone()'s time (2 stages: 1.36-1.79), at 1024 and 256 blocks
// 1.03-1.11. T1's copy (blocks = 0) launches kBlocksPerSm blocks per SM,
// the SM count read from the device, each an equal span on 16-byte edges:
// more blocks than fit on an SM at once, so the hardware hands them out in
// waves and a slow SM takes fewer; with one or two blocks per SM, each a
// fixed share, it ran 1.05-1.09 times clone() (2 x 16 KiB: 1.06-1.27),
// with eight 1.02-1.05.
// The ring, 4 stages of 16 KiB: on an H100 (PERF.md) two stages lose at 64
// blocks (one load in flight while a stage is stored), and from four stages
// up, 16 or 32 KiB each, the ring's size moved nothing beyond the run-to-run
// spread, so it is the smallest of those; no ring reached clone() at every
// block count. The ring's largest shared memory is opted into once per
// device and never lowered, so a graph captured at any span replays.
// ops/bpe_cuda.py::copy_plan mirrors the span and stage arithmetic for the
// CPU tests.
//
// Widen (K5, T1 widen): as widen.cu, each thread moves 16 input bytes per
// step with one 16-byte load and two 16-byte stores, neighbouring threads
// on neighbouring addresses, in a grid-stride loop (blocks = 0: 132 SMs x
// 16 blocks). rows * 128 is a multiple of 16, so there is no ragged tail.
//
// A chain of k launches alternates two token buffers, so no launch reads
// the token it writes.

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

#include "bulk.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kStages = 4;
constexpr int64_t kStageBytes = 16 * 1024;
constexpr int kBlocksPerSm = 8;
constexpr int kRingBytes = kStages * (int)(kStageBytes + 8);  // stages and their barriers
constexpr int kRingThreads = 32;  // one warp, of which one thread runs the ring
static_assert(kStages >= 2, "the ring reloads a stage one store behind");
static_assert(kRingBytes <= 232448, "the ring exceeds a block's shared memory");

__device__ __forceinline__ uint4 widen_lo(uint32_t a, uint32_t b) {
  // bytes b0..b3 of a word -> words [0,b0,0,b1] and [0,b2,0,b3] (LSB first)
  return make_uint4(((a & 0xFFu) << 8) | ((a & 0xFF00u) << 16),
                    ((a >> 8) & 0xFF00u) | (a & 0xFF000000u),
                    ((b & 0xFFu) << 8) | ((b & 0xFF00u) << 16),
                    ((b >> 8) & 0xFF00u) | (b & 0xFF000000u));
}

__global__ void __launch_bounds__(kThreads)
    widen_chain_kernel(const uint4* __restrict__ src, uint4* __restrict__ dst,
                       int64_t nvec, const int* __restrict__ tok_in,
                       int* __restrict__ tok_out, int add) {
  int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t v = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; v < nvec;
       v += stride) {
    uint4 x = src[v];
    dst[2 * v] = widen_lo(x.x, x.y);
    dst[2 * v + 1] = widen_lo(x.z, x.w);
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    tok_out[0] = (tok_in != nullptr ? tok_in[0] : 0) + add;
  }
}

// Block b copies bytes [b * span, min((b + 1) * span, n)) through `stages`
// stages of kStageBytes (2 <= stages <= kStages, or 1 where no span is
// longer than one stage): chunk c of the span goes through stage c % stages,
// whose barrier is then in phase c / stages.
__global__ void __launch_bounds__(kRingThreads)
    copy_ring_kernel(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst, int64_t n,
                     int64_t span, int stages, const int* __restrict__ tok_in,
                     int* __restrict__ tok_out, int add) {
  if (threadIdx.x != 0) return;
  extern __shared__ __align__(128) uint8_t ring[];
  const uint32_t base = (uint32_t)__cvta_generic_to_shared(ring);
  const uint32_t bars = base + stages * (uint32_t)kStageBytes;
  const int64_t begin = (int64_t)blockIdx.x * span;
  const int64_t len = span < n - begin ? span : n - begin;
  const int chunks = (int)((len + kStageBytes - 1) / kStageBytes);
  auto bytes = [&](int c) {
    const int64_t left = len - (int64_t)c * kStageBytes;
    return (uint32_t)(left < kStageBytes ? left : kStageBytes);
  };
  auto slot = [&](int c) { return base + (uint32_t)(c % stages) * (uint32_t)kStageBytes; };
  auto load = [&](int c) {
    stage(slot(c), src + begin + (int64_t)c * kStageBytes, bytes(c), bytes(c),
          bars + 8 * (c % stages));
  };

  for (int s = 0; s < stages; ++s) mbar_init(bars + 8 * s);
  for (int c = 0; c < stages && c < chunks; ++c) load(c);
  for (int c = 0; c < chunks; ++c) {
    mbar_wait(bars + 8 * (c % stages), (c / stages) & 1);
    bulk_store(dst + begin + (int64_t)c * kStageBytes, slot(c), bytes(c));
    // chunk c - 1's stage is free once its store, the older of the two
    // newest bulk groups, has read it
    if (c >= 1 && c - 1 + stages < chunks) {
      bulk_wait_read<1>();
      load(c - 1 + stages);
    }
  }
  bulk_wait_all();  // no store may read the ring after the block has left it
  if (blockIdx.x == 0) tok_out[0] = (tok_in != nullptr ? tok_in[0] : 0) + add;
}

// Opts copy_ring_kernel into the largest ring on device dev, once: the
// attribute holds for the device current when it is set, and a smaller
// span's launch needs no less.
int allow_ring(int dev) {
  static std::atomic<uint64_t> allowed{0};
  const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
  if (allowed.load() & bit) return 0;
  const int err = (int)cudaFuncSetAttribute(
      copy_ring_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kRingBytes);
  if (!err) allowed.fetch_or(bit);
  return err;
}

// k launches of the copy ring; see blt_chain. The grid, span and stage
// count are ops/bpe_cuda.py::copy_plan's.
int copy_chain(const uint8_t* src, uint8_t* dst, int64_t n, int blocks, const int* tok_in,
               int* tok_a, int* tok_b, int add, int k, cudaStream_t s) {
  int dev;
  int err = (int)cudaGetDevice(&dev);
  if (!err) err = allow_ring(dev);
  if (err) return err;
  int64_t want = blocks;
  if (blocks <= 0) {
    int sms;
    err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err) return err;
    want = (int64_t)sms * kBlocksPerSm;
  }
  const int64_t span = ((n + want - 1) / want + 15) / 16 * 16;
  const int grid = (int)((n + span - 1) / span);
  const int64_t pieces = (span + kStageBytes - 1) / kStageBytes;
  const int stages = pieces < kStages ? (int)pieces : kStages;
  const int smem = stages * (int)(kStageBytes + 8);
  const int* in = tok_in;
  for (int j = 0; j < k; ++j) {
    int* out = (j & 1) ? tok_b : tok_a;
    copy_ring_kernel<<<grid, kRingThreads, smem, s>>>(src, dst, n, span, stages, in, out, add);
    err = (int)cudaGetLastError();
    if (err) return err;
    if (tok_in != nullptr) in = out;
  }
  return 0;
}

}  // namespace

// widen: 0 copy, 1 widen. src: n bytes (n a multiple of 16), dst: n bytes
// or n u16, both 16-byte aligned (checked by the wrapper). tok_in: one
// int32 or NULL; tok_a, tok_b: one int32 each. Launch j reads tok_in (j = 0,
// or every launch when tok_in is NULL) or the token launch j - 1 wrote, and
// writes tok_a (j even) or tok_b (j odd). blocks: 0 sizes the grid to the
// card (the copy: kBlocksPerSm per SM; the widen: 132 SMs x 16 blocks).
// Returns the first nonzero CUDA error of the launches.
extern "C" int blt_chain(int widen, const void* src, void* dst, int64_t n,
                         const void* tok_in, void* tok_a, void* tok_b, int add,
                         int k, int blocks, void* stream) {
  if (n <= 0 || k <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (!widen) {
    return copy_chain((const uint8_t*)src, (uint8_t*)dst, n, blocks, (const int*)tok_in,
                      (int*)tok_a, (int*)tok_b, add, k, s);
  }
  int64_t nvec = n / 16;
  if (blocks <= 0) {
    int64_t want = (nvec + kThreads - 1) / kThreads;
    blocks = (int)(want < 132 * 16 ? want : 132 * 16);
  }
  const int* in = (const int*)tok_in;
  for (int j = 0; j < k; ++j) {
    int* out = (int*)((j & 1) ? tok_b : tok_a);
    widen_chain_kernel<<<blocks, kThreads, 0, s>>>(
        (const uint4*)src, (uint4*)dst, nvec, in, out, add);
    int err = (int)cudaGetLastError();
    if (err) return err;
    if (tok_in != nullptr) in = out;
  }
  return 0;
}
